"""ms a frame in the loop's 'render+copy' stage over the window (the
frame step's host work, the kernels it waits for, the copy to the host;
with --batch, a batch's wait spread over the frames written)."""


def read(record):
    total = record.stage_total("render+copy")
    return None if total is None else 1e3 * total / record.frames
