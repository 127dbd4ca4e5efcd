"""95th percentile of every request completed in the window, from the
call to Server.run until its detections are on the host (host clock)."""
import statistics


def read(run):
    lat = run.extra.get("latencies_ms")
    if not lat or len(lat) < 2:
        return None
    return statistics.quantiles(lat, n=20, method="inclusive")[18]
