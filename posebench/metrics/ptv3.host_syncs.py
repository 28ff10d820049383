"""Host reads a Point Transformer V3 forward made (the backbone's
`host_syncs` counter after a served call: the depth and each level's
per-cloud voxel counts); a count a call."""


def read(trace):
    return trace.get("host_syncs")
