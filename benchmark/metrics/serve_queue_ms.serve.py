"""Queue wait of the tail requests, ms: over the profiler window's requests
whose server-side time (the program's span serve.request, body read to
response written) is at or past its 95th percentile, the mean of their
serve.queue span (cli/serve: put in the queue until its micro-batch closes,
the batch window included)."""

from benchmark import program_spans


def read(obs):
    return program_spans.tail_mean_ms(program_spans.profiled(), ("serve.queue",))
