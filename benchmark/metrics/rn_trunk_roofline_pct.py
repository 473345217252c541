"""The RN50 stem and trunk's share of their roofline, %: the least time of
its 55 convolutions on the card (benchmark/work.py rn_trunk_bound_s: each
call's operations at the bf16 peak or its bytes, a fused call's residual
included) over the device time of models/resnet.resnet_features by CUDA
events, summed over the window's batches. The work is counted from shapes,
so it reads the same whatever implements the convolutions."""


def read(obs):
    bound = obs.work.get('trunk_bound_s')
    spent = sum(obs.spans.get('trunk', []))
    if not bound or not spent:
        return None
    return 100.0 * bound / spent
