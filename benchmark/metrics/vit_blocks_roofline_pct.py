"""The ViT's twelve W8A8 layers' share of their roofline, %: the least time
of their kernels' work (benchmark/work.py vit_blocks_bound_s: int8 products
at the int8 peak, attention and out projection at the bf16 peak, or the
bytes) over the device time of the blocks (models/transformer.run_transformer
in the ViT) by CUDA events, summed over the window's batches."""


def read(obs):
    bound = obs.work.get('blocks_bound_s')
    spent = sum(obs.spans.get('blocks', []))
    if not bound or not spent:
        return None
    return 100.0 * bound / spent
