"""CPU tests of the benchmark: `python -m pytest posebench/tests` from the
root of the repo.  Tests marked `cuda` run on the card only."""
