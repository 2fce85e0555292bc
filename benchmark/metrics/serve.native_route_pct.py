"""serve.native_route_pct: the share of the window's requests that the
port's router sent to the native host route (predict.last_route after the
call)."""


def read(run):
    routes = [u.route for u in run.units if not u.failed]
    if run.kind != "serve" or not routes:
        return None
    return 100.0 * sum(r == "native" for r in routes) / len(routes)
