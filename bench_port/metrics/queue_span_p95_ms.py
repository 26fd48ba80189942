"""queue_span_p95_ms: 95th percentile, over the requests due in the
window, of their first ``queue`` lane span: from the submit (or the step
that drains an arrival ahead of the engine's clock) to the step that
admits them; one never admitted waits from its submit, or its due time,
until the run stopped."""
from bench_port.lib import spans, stats


def read(run):
    if spans.of(run) is None:
        return None
    submit, queue = {}, {}
    for e in run.spans.events:
        rid = e.get("req")
        if rid is None:
            continue
        if e["name"] == "submit":
            submit.setdefault(rid, e["t"])
        elif e["name"] == "queue" and e["ph"] == "X":
            queue.setdefault(rid, e["dur"])
    waits = [queue.get(r.req_id, run.end - submit.get(r.req_id, r.due))
             for r in stats.window_requests(run)]
    v = stats.p95(waits)
    return None if v is None else 1e3 * v
