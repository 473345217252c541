"""Host work of the tail requests, ms: over the profiler window's requests
whose server-side time (the program's span serve.request) is at or past its
95th percentile, the mean of their serve.decode + serve.stage + serve.launch
+ serve.respond spans (cli/serve: the handler's decode, the worker's
stage_batch_fused and dispatch_staged_fused of the request's micro-batch,
the response written)."""

from benchmark import program_spans


def read(obs):
    return program_spans.tail_mean_ms(
        program_spans.profiled(), ("serve.decode", "serve.stage", "serve.launch", "serve.respond"))
