"""ms a frame in the loop's 'encode+write' stage over the window (the
host's ANSI expansion and the write to the terminal): the program's own
stage, timed by the harness's stage clock."""


def read(record):
    total = record.stage_total("encode+write")
    return None if total is None else 1e3 * total / record.frames
