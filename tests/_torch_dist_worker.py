"""One rank of a torch.distributed group over gloo on the CPU, for
tests/test_torch_parallel.py and tests/test_torch_multigpu.py: a real OS
process, as torchrun would start it on a card, that joins the group through
a ``file://`` rendezvous under the test's own directory (so parallel test
workers never share a port), caps itself at one torch thread, reads its
inputs from ``<dir>/inputs.pkl`` and writes ``<dir>/<mode>_<rank>.pkl``.

Usage: python _torch_dist_worker.py <mode> <rank> <world> <dir>

Imports only torch, numpy and the port: the JAX side of each comparison runs
in the parent test. :func:`run_ranks` starts the ranks from the parent, each
with its own timeout, so a hang fails fast."""

import os
import pickle
import subprocess
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402

RANK_TIMEOUT_S = 120


def run_ranks(mode, world, directory, inputs, timeout=RANK_TIMEOUT_S):
    """Start ``world`` ranks of ``mode`` on ``inputs``; returns each rank's
    result, in rank order. A rank that fails or outlives ``timeout`` fails
    the caller with its output."""
    directory = str(directory)
    os.makedirs(directory, exist_ok=True)
    with open(os.path.join(directory, "inputs.pkl"), "wb") as f:
        pickle.dump(inputs, f)
    env = dict(os.environ, OMP_NUM_THREADS="1", MKL_NUM_THREADS="1")
    for var in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT"):
        env.pop(var, None)
    procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), mode, str(r),
                               str(world), directory],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
                              env=env)
             for r in range(world)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=timeout)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for r, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"{mode} rank {r} of {world} failed:\n{out}"
    results = []
    for r in range(world):
        with open(os.path.join(directory, f"{mode}_{r}.pkl"), "rb") as f:
            results.append(pickle.load(f))
    return results


def _np(tree):
    """Tensors of a nested dict → numpy arrays."""
    import torch

    if isinstance(tree, dict):
        return {k: _np(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_np(v) for v in tree)
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu().numpy()
    return tree


# --------------------------------- modes --------------------------------------


def mode_collectives(inputs, mesh):
    """The mesh helpers and the ring kNN at this world."""
    import torch

    from leclip_tpu_torch.parallel import mesh as M
    from leclip_tpu_torch.parallel.retrieval import retrieval_augment_sharded

    out = {"rank": mesh.rank, "world": mesh.world}
    # replicate: rank 0's value everywhere, the caller's array untouched;
    # non-array leaves pass through
    mine = np.full((3, 2), float(mesh.rank), np.float32)
    rep = M.replicate({"w": mine, "meta": "end", "n": 3}, mesh)
    out["replicated"] = rep["w"].numpy()
    out["replicate_kept_input"] = bool((mine == mesh.rank).all())
    out["static"] = (rep["meta"], rep["n"])
    # a strided leaf keeps its strides (the int8 kernels' weight layout)
    strided = M.replicate(torch.arange(12.0).reshape(3, 4).t() + mesh.rank, mesh)
    out["replicated_strided"] = (strided.numpy(), strided.stride())
    # quantize_stack_on_device(mesh=): rank 0's codes and scales on every
    # rank, though each rank's blocks differ here
    from leclip_tpu_torch.models.transformer import init_block_stack
    from leclip_tpu_torch.ops.quant import quantize_stack_on_device

    blocks = init_block_stack(torch.Generator().manual_seed(0), 2, 64, device="cpu")
    blocks["mlp"]["fc_kernel"] = blocks["mlp"]["fc_kernel"] + 1e-2 * mesh.rank
    q8 = quantize_stack_on_device(blocks, mesh=mesh)
    out["q8"] = _np(q8)
    out["q8_strides"] = q8["mlp"]["fc"][0].stride()
    # put_global / shard_along keep this rank's rows; fetch_global gathers
    x = inputs["x"]
    local = M.put_global(x, mesh)
    out["local_rows"] = local.numpy()
    out["fetched"] = M.fetch_global(local, mesh)
    out["fetched_dim1"] = M.fetch_global(M.put_global(x.T.copy(), mesh, dim=1), mesh, dim=1)
    out["shard_along"] = M.shard_along({"bank": x}, mesh)["bank"].numpy()
    out["all_reduce_mean"] = M.all_reduce_mean(
        [torch.tensor([float(mesh.rank)]), torch.tensor([2.0 * mesh.rank], dtype=torch.float64)],
        mesh)
    # gather_with_grad: the global loss's gradient, rank by rank
    w = torch.tensor(inputs["w"], requires_grad=True)
    rows = M.put_global(inputs["feat"], mesh)
    full = M.gather_with_grad(rows @ w, mesh)
    loss = (full.square().sum(-1) * torch.arange(1, full.shape[0] + 1)).mean()
    (g,) = torch.autograd.grad(loss, [w])
    out["gather_grad"] = M.all_reduce_mean([g], mesh)[0].numpy()
    out["gather_loss"] = float(loss)
    # the ring kNN over a row-sharded bank, exact and 83-row padded
    gf = M.put_global(inputs["gf"], mesh)
    for tag, bank, n_valid in (("exact", inputs["bank"], None),
                               ("padded", inputs["bank_padded"], inputs["n_valid"])):
        aug, scores = retrieval_augment_sharded(gf, M.put_global(bank, mesh), inputs["topk"],
                                                mesh, n_valid=n_valid, bank_rows=len(bank))
        out[f"ring_{tag}"] = (M.fetch_global(aug, mesh), M.fetch_global(scores, mesh))
    # prefetch over the mesh: the same batches as the inline loop
    batches = [{"x": x + i} for i in range(3)]
    out["prefetch"] = [b["x"].numpy() for b in M.prefetch_sharded(iter(batches), mesh, 2)]
    return out


def _train_cfg(inputs, extra, **kwargs):
    from leclip_tpu_torch.engine.config import setup_config

    return setup_config(opts=inputs["opts"] + extra, SEED=3, **kwargs)


def _trainer(inputs, cfg, mesh):
    from leclip_tpu_torch.data.datasets import CaptionDataset
    from leclip_tpu_torch.engine.checkpoint import restore_train_state
    from leclip_tpu_torch.engine.trainer import CaptionDistillTrainer
    from leclip_tpu_torch.models.clip import PRESETS
    from leclip_tpu_torch.models.convert import from_jax_params

    ds = CaptionDataset(inputs["tokens"], inputs["labels"], [], inputs["classnames"])
    tr = CaptionDistillTrainer(cfg, from_jax_params(inputs["clip_params"], "cpu"),
                               PRESETS["RN-TEST"], dataset=ds, mesh=mesh)
    # the start state of the JAX trainer of the parent
    tr.state = restore_train_state(tr.state, {
        k: from_jax_params(v, "cpu") if isinstance(v, dict) else v
        for k, v in inputs["state"].items()})
    return tr


def mode_train(inputs, mesh):
    """The data-parallel trainer: one explicit step, train() with rank-0
    checkpoints into per-rank directories, the same with prefetch 2, and a
    resume from a shared directory."""
    from leclip_tpu_torch.engine.checkpoint import latest_checkpoint
    from leclip_tpu_torch.parallel.multihost import barrier

    d = inputs["dir"]
    out = {}
    tr = _trainer(inputs, _train_cfg(inputs, ["TRAIN.CHECKPOINT_FREQ", "1"],
                                     OUTPUT_DIR=os.path.join(d, f"proc{mesh.rank}")), mesh)
    out["num_shards"] = (tr.batcher.shard_index, tr.batcher.num_shards)
    first = next(iter(tr.batcher.epoch(0)))
    out["local_batch"] = first
    state1, aux = tr.train_step(tr.state, first["img"], first["label"])
    out["params_step1"] = _np(state1.params)
    out["loss_step1"] = float(aux["loss"])
    out["params_final"] = _np(tr.train(resume=False).params)
    pre = _trainer(inputs, _train_cfg(inputs, ["TRAIN.prefetch_batches", "2"],
                                      OUTPUT_DIR=os.path.join(d, "prefetch")), mesh)
    out["params_prefetch"] = _np(pre.train(resume=False).params)

    shared = os.path.join(d, "shared_out")
    barrier()
    tr1 = _trainer(inputs, _train_cfg(inputs, ["TRAIN.CHECKPOINT_FREQ", "1"],
                                      OUTPUT_DIR=shared, RESUME=shared), mesh)
    tr1.train(resume=False)
    ck = latest_checkpoint(shared, tr1.model_name)
    out["phase1_ckpt"] = os.path.basename(ck)
    tr2 = _trainer(inputs, _train_cfg(inputs, ["TRAIN.CHECKPOINT_FREQ", "1",
                                               "OPTIM.MAX_EPOCH", "4"],
                                      OUTPUT_DIR=shared, RESUME=shared), mesh)
    resumed = {}
    step = tr2.train_step

    def first_state(state, *a, **k):  # the state train() starts from after the resume
        resumed.setdefault("params", _np(state.params))
        return step(state, *a, **k)

    tr2.train_step = first_state
    out["final_params"] = _np(tr2.train(resume=True).params)
    out["resumed_params"] = resumed["params"]
    return out


def mode_finetune(inputs, mesh):
    """The data-parallel fine-tuner: the gradient of the global batch's loss
    at the start, one train_step and one raw_train_step (augmentation on
    the device) on this rank's rows."""
    import torch

    from leclip_tpu_torch.engine.finetune import CLIPFineTuner
    from leclip_tpu_torch.models.clip import PRESETS
    from leclip_tpu_torch.models.convert import from_jax_params, to_jax_params
    from leclip_tpu_torch.parallel.mesh import put_global

    cfg = PRESETS["ViT-TEST"]
    tuner = CLIPFineTuner(from_jax_params(inputs["params"], "cpu"), cfg, lr=1e-3,
                          warmup_steps=0, total_steps=10, mesh=mesh)
    images = put_global(inputs["images"], mesh)
    tokens = put_global(inputs["tokens"], mesh)
    loss, acc, grads = tuner._loss_and_grads(tuner.state.params, images, tokens)
    out = {"loss": float(loss), "acc": float(acc), "grads": to_jax_params(grads)}
    state, m = tuner.train_step(tuner.state, images, tokens)
    out["step"] = {k: float(v) for k, v in m.items()}
    out["params"] = to_jax_params(state.params)
    raw = {k: put_global(v, mesh) for k, v in inputs["raw"].items()}
    _, m = tuner.raw_train_step(state, 7, raw["image_u8"], raw["content"], raw["tokens"])
    out["raw_step"] = {k: float(v) for k, v in m.items()}
    with torch.no_grad():
        out["logit_scale"] = float(state.params["logit_scale"])
    return out


def build_engine(inputs, mesh, shard_bank):
    """The port's counterpart of tests/_multihost_infer_worker.build_engine
    on the parent's JAX parameters and prompts: ViT-TEST, two members
    ("best" with evidence, "ema"), a 37-row bank, scales (2,), top 5."""
    import torch

    from leclip_tpu_torch.inference.tta import TTAEngine, build_model_spec
    from leclip_tpu_torch.models.clip import PRESETS
    from leclip_tpu_torch.models.convert import from_jax_params
    from leclip_tpu_torch.models.dense_clip import DenseFlags
    from leclip_tpu_torch.models.prompt import build_prompt_learner

    cfg = PRESETS["ViT-TEST"]
    params = from_jax_params(inputs["params"], "cpu")
    specs = {}
    for i, name in enumerate(("best", "ema")):
        _, constants = build_prompt_learner(torch.Generator().manual_seed(0), params,
                                            inputs["classnames"], n_ctx=4)
        specs[name] = build_model_spec(params, cfg, from_jax_params(inputs["trainables"][i],
                                                                    "cpu"),
                                       constants, DenseFlags(use_evidence=(i == 0)))
    return TTAEngine(params, cfg, specs, scales=(2,), crop_size=cfg.image_resolution,
                     caption_bank=None if inputs["bank"] is None else torch.tensor(inputs["bank"]),
                     topk=5,
                     device="cpu" if mesh is None else None, mesh=mesh,
                     shard_bank=shard_bank)


def mode_engine(inputs, mesh):
    """The mesh engine with a row-sharded bank: the fused path (uniform,
    mixed and partial batches, pipelined), the dump path and its
    multi-dispatch check."""
    engine = build_engine(inputs, mesh, shard_bank=True)
    uniform, mixed = inputs["uniform"], inputs["mixed"]
    out = {"bank_shard_rows": int(engine.caption_bank.shape[0]),
           "uniform": engine.run_batch_fused(uniform),
           "mixed": engine.run_batch_fused(mixed),
           "partial": engine.run_batch_fused(uniform[:5]),
           "piped": list(engine.run_batches_fused([uniform, mixed], depth=2)),
           "staged": list(engine.run_batches_fused_staged(iter([mixed, uniform[:5]]))),
           "dump": engine.run_batch(mixed[:5]),
           "multidispatch": engine.run_batch_multidispatch(mixed[:5])}
    return out


MODES = {"collectives": mode_collectives, "train": mode_train, "finetune": mode_finetune,
         "engine": mode_engine}


def main():
    mode, rank, world, directory = sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), sys.argv[4]
    import torch

    torch.set_num_threads(1)
    from leclip_tpu_torch.parallel import multihost
    from leclip_tpu_torch.parallel.mesh import data_mesh

    multihost.initialize(device="cpu", init_method=f"file://{os.path.join(directory, 'rdv')}",
                         world_size=world, rank=rank, timeout_s=RANK_TIMEOUT_S)
    mesh = data_mesh()
    assert (mesh.rank, mesh.world, mesh.device.type) == (rank, world, "cpu")
    assert multihost.is_primary() == (rank == 0)
    with open(os.path.join(directory, "inputs.pkl"), "rb") as f:
        inputs = pickle.load(f)
    result = MODES[mode](inputs, mesh)
    with open(os.path.join(directory, f"{mode}_{rank}.pkl"), "wb") as f:
        pickle.dump(result, f)
    multihost.barrier()
    multihost.shutdown()
    print(f"{mode} rank {rank} of {world} ok", flush=True)


if __name__ == "__main__":
    main()
