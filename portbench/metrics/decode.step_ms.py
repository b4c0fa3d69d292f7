"""Wall ms a decode step: the tracer's ``decode-segment`` spans in the
window (traced runs synchronise the device before a span closes) over
their steps."""


def read(run):
    segs = [t1 - t0 for name, _, t0, t1 in run.spans
            if name == "decode-segment" and run.w0 <= t0 < run.w1]
    if not segs:
        return None
    return sum(segs) / (len(segs) * run.mix.sync_every) * 1e3
