"""Host reads a MinkUNet forward made (the backbone's `host_syncs`
counter after a served call: the grid's depth, then every stride's
per-cloud voxel counts at once); a count a call."""


def read(trace):
    return trace.get("minkunet_host_syncs")
