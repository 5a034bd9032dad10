"""The share of the window in which no kernel, copy or set ran on the card
(the profiler's timeline), in %."""


def read(st):
    dt = st.device_trace
    if not dt or not dt.get("busy_s"):
        return None
    return 100.0 * (1.0 - dt["busy_s"] / dt["window_s"])
