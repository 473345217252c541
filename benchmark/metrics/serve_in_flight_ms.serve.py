"""In-flight time of the tail requests, ms: over the profiler window's
requests whose server-side time (the program's span serve.request) is at or
past its 95th percentile, the mean of their serve.in_flight span (cli/serve:
launched until the scores are on the host: the device's work, the batch
ahead of it in the worker's pipeline, the fetch). With serve_queue_ms.serve
and serve_host_ms.serve it sums to the tail's mean server-side time."""

from benchmark import program_spans


def read(obs):
    return program_spans.tail_mean_ms(program_spans.profiled(), ("serve.in_flight",))
