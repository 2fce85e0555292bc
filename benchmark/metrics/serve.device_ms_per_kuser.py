"""serve.device_ms_per_kuser: the union of device intervals in the traced
window, ms per 1,000 users served."""


def read(run):
    users = sum(u.work for u in run.units)
    if run.trace is None or run.kind != "serve" or users == 0:
        return None
    return 1e3 * run.trace.busy_s() / (users / 1e3)
