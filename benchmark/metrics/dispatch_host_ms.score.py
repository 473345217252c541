"""Host time a batch in TTAEngine.dispatch_staged_fused, ms: the program's
span score.dispatch (leclip_tpu_torch/utils/tracing.py) over the profiler
window's batches, the host's cost of queueing the batch's launches (crops,
tower, retrieval, every member's logits, fusion). Near the device time of a
batch, the cell is launch-bound."""

from benchmark import program_spans


def read(obs):
    return program_spans.host_ms(program_spans.profiled(), "score.dispatch")
