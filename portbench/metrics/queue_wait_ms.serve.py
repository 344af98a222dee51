"""queue_wait_ms.serve: the mean of the server's ``queue_wait`` spans
(``serve/tracing``: a request's wait in the batcher, from joining it to
its batch's packing) in the traced run."""


def read(run):
    waits = run.spans.get("queue_wait_s")
    if not waits:
        return None
    return 1e3 * sum(waits) / len(waits)
