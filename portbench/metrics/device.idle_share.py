"""Share of the traced stretch (%) in which no kernel, copy or set ran on
the device (``torch.profiler``; the union of the device events)."""


def read(run):
    st = run.stretch
    if st is None or st.window_s <= 0 or not st.events:
        return None
    return 100.0 * (1.0 - st.busy_s() / st.window_s)
