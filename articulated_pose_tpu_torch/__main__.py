"""`python -m articulated_pose_tpu_torch <command> ...`: the command line
of `articulated_pose_tpu_torch.main`."""

from articulated_pose_tpu_torch.main import main

main()
