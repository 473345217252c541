"""The port's data mesh (leclip_tpu_torch/parallel/) against the JAX
package's (tests/test_parallel.py, tests/test_multihost.py): the mesh
helpers at world 1, the prefetch thread, cluster detection and the no-op
join, and over gloo on the CPU — real OS processes, one a rank, as torchrun
starts them on the cards (tests/_torch_dist_worker.py) — the collectives at
world 2 and 4 and the ring kNN over a row-sharded bank, held against JAX's
``retrieval_augment_sharded`` on the 8-device virtual mesh and the port's
replicated ``retrieval_augment`` within 1e-5 (both searches are exact fp32
on the CPU; they differ by summation order)."""

import threading
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_dist_worker import run_ranks
from leclip_tpu.models import dense_clip as jdc
from leclip_tpu.parallel import mesh as jmesh
from leclip_tpu.parallel.retrieval import retrieval_augment_sharded as jring
from leclip_tpu_torch.models.dense_clip import retrieval_augment
from leclip_tpu_torch.parallel import mesh as M
from leclip_tpu_torch.parallel import multihost
from leclip_tpu_torch.parallel.retrieval import retrieval_augment_sharded

torch.set_num_threads(2)
RING_TOL = 1e-5


@pytest.mark.parametrize("mode", ["wrap", "zero"])
@pytest.mark.parametrize("n,multiple", [(10, 8), (16, 8), (83, 4), (5, 2)])
def test_pad_to_multiple_matches_jax(mode, n, multiple):
    arr = np.arange(n * 3, dtype=np.float32).reshape(n, 3)
    got, n0 = M.pad_to_multiple(arr, multiple, mode=mode)
    want, m0 = jmesh.pad_to_multiple(arr, multiple, mode=mode)
    assert n0 == m0 == n and got.shape[0] % multiple == 0
    np.testing.assert_array_equal(got, want)
    with pytest.raises(ValueError, match="wrap | zero"):
        M.pad_to_multiple(arr, 7 if n % 7 else 3, mode="edge")


@pytest.mark.parametrize("num_shards", [2, 4])
def test_caption_batcher_shards_equal_jax(num_shards):
    """Each rank's CaptionBatcher shard: JAX's contiguous slice of every
    epoch's permutation, the same batches, and together every row once."""
    from leclip_tpu.data.loader import CaptionBatcher as JBatcher
    from leclip_tpu_torch.data.loader import CaptionBatcher

    rng = np.random.default_rng(2)
    toks = rng.integers(0, 1000, (70, 77)).astype(np.int32)
    labs = (rng.random((70, 5)) < 0.3).astype(np.int8)
    seen = []
    for shard in range(num_shards):
        want = JBatcher(toks, labs, 8, seed=3, shard_index=shard, num_shards=num_shards)
        got = CaptionBatcher(toks, labs, 8, seed=3, shard_index=shard, num_shards=num_shards)
        assert got.steps_per_epoch() == want.steps_per_epoch()
        for epoch in range(2):
            for a, b in zip(got.epoch(epoch), want.epoch(epoch), strict=True):
                np.testing.assert_array_equal(a["img"], b["img"])
                np.testing.assert_array_equal(a["label"], b["label"])
        seen += [b["img"] for b in got.epoch(0)]
    rows = np.concatenate(seen)
    assert len({r.tobytes() for r in rows}) == len(rows)  # no row in two shards
    with pytest.raises(ValueError, match="shard_index"):
        CaptionBatcher(toks, labs, 8, shard_index=num_shards, num_shards=num_shards)


def test_world_one_helpers_are_local():
    mesh = M.data_mesh("cpu")
    assert (mesh.rank, mesh.world, mesh.distributed) == (0, 1, False)
    batch = {"img": np.arange(12, dtype=np.int32).reshape(4, 3), "meta": "x",
             "pair": (np.ones(2, np.float32), 3)}
    sb = M.shard_batch(batch, mesh)
    assert isinstance(sb["img"], torch.Tensor) and sb["meta"] == "x" and sb["pair"][1] == 3
    np.testing.assert_array_equal(sb["img"].numpy(), batch["img"])
    x = np.random.default_rng(0).normal(size=(6, 4)).astype(np.float32)
    np.testing.assert_array_equal(M.put_global(x, mesh).numpy(), x)
    np.testing.assert_array_equal(M.fetch_global(torch.tensor(x), mesh), x)
    rep = M.replicate({"w": x, "meta": "end", "n": 3}, mesh)
    assert rep["meta"] == "end" and rep["n"] == 3
    np.testing.assert_array_equal(rep["w"].numpy(), x)
    np.testing.assert_array_equal(M.shard_along({"b": x}, mesh)["b"].numpy(), x)
    t = torch.ones(3, requires_grad=True)
    assert M.gather_with_grad(t, mesh) is t and M.all_reduce_mean([t], mesh)[0] is t


def _batches(n=5):
    rng = np.random.default_rng(1)
    return [{"img": rng.integers(0, 100, (16, 7), dtype=np.int32),
             "label": rng.normal(size=(16, 4)).astype(np.float32)} for _ in range(n)]


@pytest.mark.parametrize("depth", [0, 1, 3])
def test_prefetch_sharded_matches_inline(depth):
    """The prefetch thread yields the inline loop's batches, in order, on
    the mesh's device, at every depth (0 is the inline loop itself)."""
    mesh = M.local_mesh("cpu")
    batches = _batches()
    want = [M.shard_batch(b, mesh) for b in batches]
    got = list(M.prefetch_sharded(iter(batches), mesh, depth=depth))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        for k in w:
            assert g[k].device == w[k].device and g[k].dtype == w[k].dtype
            assert torch.equal(g[k], w[k])


def test_prefetch_sharded_propagates_producer_error():
    mesh = M.local_mesh("cpu")

    def bad_batches():
        yield {"x": np.zeros((8, 2), np.float32)}
        raise RuntimeError("boom in producer")

    with pytest.raises(RuntimeError, match="boom in producer"):
        list(M.prefetch_sharded(bad_batches(), mesh, depth=2))


def test_prefetch_sharded_reaps_thread_on_abandonment():
    """Abandoning the consumer mid-epoch (the NaN guard) must not leave the
    producer blocked on a full queue."""
    mesh = M.local_mesh("cpu")
    n_before = threading.active_count()

    def many_batches():
        for _ in range(100):
            yield {"x": np.zeros((8, 2), np.float32)}

    it = M.prefetch_sharded(many_batches(), mesh, depth=1)
    next(it)
    it.close()
    deadline = 50
    while threading.active_count() > n_before and deadline:
        time.sleep(0.1)
        deadline -= 1
    assert threading.active_count() <= n_before


def test_cluster_env_detection_requires_multiprocess_evidence(monkeypatch):
    """torchrun's WORLD_SIZE, SLURM's task count and Open MPI's world size
    count only above 1; a one-task allocation is one process."""
    for var in ("WORLD_SIZE", "SLURM_NTASKS", "OMPI_COMM_WORLD_SIZE"):
        monkeypatch.delenv(var, raising=False)
    assert not multihost._cluster_env_detected()
    for var in ("WORLD_SIZE", "SLURM_NTASKS", "OMPI_COMM_WORLD_SIZE"):
        monkeypatch.setenv(var, "1")
        assert not multihost._cluster_env_detected()
        monkeypatch.setenv(var, "bad")
        assert not multihost._cluster_env_detected()
        monkeypatch.setenv(var, "4")
        assert multihost._cluster_env_detected()
        monkeypatch.delenv(var)


def test_initialize_noop_outside_cluster_and_raises_inside(monkeypatch):
    """No cluster markers: initialize() is a silent no-op and this process
    is primary. Markers without torchrun's rendezvous variables: it raises
    instead of leaving every rank primary."""
    import torch.distributed as dist

    for var in ("WORLD_SIZE", "SLURM_NTASKS", "OMPI_COMM_WORLD_SIZE") + multihost.TORCHRUN_VARS:
        monkeypatch.delenv(var, raising=False)
    assert multihost.initialize(device="cpu") is False
    assert not dist.is_initialized() and multihost.is_primary()
    multihost.barrier()  # no-op without a group
    monkeypatch.setenv("SLURM_NTASKS", "2")
    with pytest.raises(RuntimeError, match="multi-process launch"):
        multihost.initialize(device="cpu")
    assert not dist.is_initialized()


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], f"{prefix}/{k}")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{prefix}/{i}")
    else:
        yield prefix, tree


def _ring_inputs():
    rng = np.random.default_rng(0)
    E, N, B, K = 32, 160, 16, 5
    gf = rng.normal(size=(B, E)).astype(np.float32)
    gf /= np.linalg.norm(gf, axis=-1, keepdims=True)
    bank = rng.normal(size=(N, E)).astype(np.float32)
    bank /= np.linalg.norm(bank, axis=-1, keepdims=True)
    odd = bank[:83].copy()
    odd[10:20] *= 0.3  # unnormalised rows: a norm test would drop them
    return gf, bank, odd, K


def test_ring_knn_checks_its_shapes():
    mesh = M.local_mesh("cpu")
    gf, bank, _, k = _ring_inputs()
    with pytest.raises(ValueError, match="divide the world"):
        retrieval_augment_sharded(torch.tensor(gf), torch.tensor(bank), k, mesh.__class__(
            0, 3, mesh.device), bank_rows=160)
    with pytest.raises(ValueError, match="smaller than topk"):
        retrieval_augment_sharded(torch.tensor(gf), torch.tensor(bank[:3]), k, mesh)
    with pytest.raises(ValueError, match="expected"):
        retrieval_augment_sharded(torch.tensor(gf), torch.tensor(bank[:40]), k, mesh,
                                  bank_rows=80)
    # world 1: the one shard searched in place equals the replicated search
    aug, scores = retrieval_augment_sharded(torch.tensor(gf), torch.tensor(bank), k, mesh)
    aug_r, scores_r = retrieval_augment(torch.tensor(gf), torch.tensor(bank), k)
    np.testing.assert_allclose(aug.numpy(), aug_r.numpy(), rtol=RING_TOL, atol=RING_TOL)
    np.testing.assert_allclose(scores.numpy(), scores_r.numpy(), rtol=RING_TOL, atol=RING_TOL)


@pytest.fixture(scope="module")
def jax_ring():
    """JAX's ring on the 8-device virtual mesh: the 160-row bank, and the
    83-row bank zero-padded to 88 with n_valid 83."""
    gf, bank, odd, k = _ring_inputs()
    mesh = jmesh.data_mesh()
    gf_d = jmesh.shard_batch({"x": gf}, mesh)["x"]
    out = {"exact": jring(gf_d, jmesh.shard_along(jnp.asarray(bank), mesh), k, mesh)}
    padded, n0 = jmesh.pad_to_multiple(odd, 8, mode="zero")
    out["padded"] = jring(gf_d, jmesh.shard_along(jnp.asarray(padded), mesh), k, mesh,
                          n_valid=n0)
    return {tag: tuple(np.asarray(a) for a in v) for tag, v in out.items()}


@pytest.mark.parametrize("world", [2, 4])
def test_collectives_and_ring_knn_over_gloo(world, tmp_path, jax_ring):
    gf, bank, odd, k = _ring_inputs()
    padded, n0 = M.pad_to_multiple(odd, world, mode="zero")
    rng = np.random.default_rng(3)
    x = rng.normal(size=(4 * world, 3)).astype(np.float32)
    feat = rng.normal(size=(2 * world, 5)).astype(np.float32)
    w = rng.normal(size=(5, 4)).astype(np.float32)
    res = run_ranks("collectives", world, tmp_path, dict(
        x=x, feat=feat, w=w, gf=gf, bank=bank, bank_padded=padded, n_valid=n0, topk=k))

    # the reference gradient of the global loss, one process
    wt = torch.tensor(w, requires_grad=True)
    full = torch.tensor(feat) @ wt
    loss = (full.square().sum(-1) * torch.arange(1, full.shape[0] + 1)).mean()
    (g_ref,) = torch.autograd.grad(loss, [wt])
    replicated = {"exact": retrieval_augment(torch.tensor(gf), torch.tensor(bank), k),
                  "padded": retrieval_augment(torch.tensor(gf), torch.tensor(odd), k)}
    per = len(x) // world
    from leclip_tpu_torch.models.transformer import init_block_stack
    from leclip_tpu_torch.ops.quant import quantize_stack_on_device

    want_q8 = quantize_stack_on_device(init_block_stack(torch.Generator().manual_seed(0), 2, 64,
                                                        device="cpu"))
    for r, out in enumerate(res):
        strided, stride = out["replicated_strided"]
        np.testing.assert_array_equal(strided, np.arange(12.0).reshape(3, 4).T)
        assert stride == (1, 4)
        assert out["q8_strides"] == want_q8["mlp"]["fc"][0].stride()
        for (k, a), (_, b) in zip(_leaves(out["q8"]), _leaves(want_q8)):
            np.testing.assert_array_equal(a, b.numpy(), err_msg=k)
        assert (out["rank"], out["world"]) == (r, world)
        np.testing.assert_array_equal(out["replicated"], np.zeros((3, 2), np.float32))
        assert out["replicate_kept_input"] and out["static"] == ("end", 3)
        np.testing.assert_array_equal(out["local_rows"], x[r * per:(r + 1) * per])
        np.testing.assert_array_equal(out["shard_along"], x[r * per:(r + 1) * per])
        np.testing.assert_array_equal(out["fetched"], x)
        np.testing.assert_array_equal(out["fetched_dim1"], x.T)
        mean = (world - 1) / 2
        assert [float(t) for t in out["all_reduce_mean"]] == [mean, 2 * mean]
        assert out["all_reduce_mean"][1].dtype == torch.float64
        np.testing.assert_allclose(out["gather_loss"], float(loss.detach()), rtol=1e-6)
        np.testing.assert_allclose(out["gather_grad"], g_ref.numpy(), rtol=1e-5, atol=1e-6)
        for i, b in enumerate(out["prefetch"]):
            np.testing.assert_array_equal(b, x + i)
        for tag in ("exact", "padded"):
            aug, scores = out[f"ring_{tag}"]
            aug_r, scores_r = (t.numpy() for t in replicated[tag])
            for got, want in ((aug, aug_r), (scores, scores_r),
                              (aug, jax_ring[tag][0]), (scores, jax_ring[tag][1])):
                np.testing.assert_allclose(got, want, rtol=RING_TOL, atol=RING_TOL,
                                           err_msg=f"rank {r} {tag}")
            assert (np.diff(scores, axis=-1) <= 1e-7).all()
        # every rank holds the same bits
        for key in ("fetched", "gather_grad"):
            np.testing.assert_array_equal(out[key], res[0][key])
        for tag in ("exact", "padded"):
            for a, b in zip(out[f"ring_{tag}"], res[0][f"ring_{tag}"]):
                np.testing.assert_array_equal(a, b)


def test_replicated_retrieval_matches_jax_exact_search():
    """The two references of the ring agree: the port's replicated search
    and JAX's exact one."""
    gf, bank, odd, k = _ring_inputs()
    for b in (bank, odd):
        want = jdc.retrieval_augment(jnp.asarray(gf), jnp.asarray(b), k, exact=True)
        got = retrieval_augment(torch.tensor(gf), torch.tensor(b), k)
        for g, w in zip(got, want):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=RING_TOL, atol=RING_TOL)


def test_augment_and_dense_forward_entry_points_match_their_parts():
    """The top-level convenience names the port adds for the JAX package's
    table are their parts composed: randaugment / autoaugment = sample +
    apply from one generator, dense_test_forward = the image tower + the
    test logits."""
    from leclip_tpu_torch.models.clip import PRESETS, init_clip_params
    from leclip_tpu_torch.models.dense_clip import (DenseFlags, dense_test_forward,
                                                    encode_image_features,
                                                    test_logits_from_features)
    from leclip_tpu_torch.ops import autoaugment as aa
    from leclip_tpu_torch.ops import randaugment as ra

    img = torch.rand(32, 40, 3, generator=torch.Generator().manual_seed(0))
    got = ra.randaugment(torch.Generator().manual_seed(5), img, num_ops=2, magnitude=9.0)
    want = ra.randaugment_apply(img, ra.sample_randaugment(torch.Generator().manual_seed(5), 2),
                                9.0)
    assert torch.equal(got, want)
    got = aa.autoaugment(torch.Generator().manual_seed(6), img, "mlc")
    want = aa.autoaugment_apply(img, aa.sample_autoaugment(torch.Generator().manual_seed(6),
                                                           "mlc"), "mlc")
    assert torch.equal(got, want)

    cfg = PRESETS["ViT-TEST"]
    params = init_clip_params(torch.Generator().manual_seed(0), cfg, device="cpu")
    flags = DenseFlags()
    gen = torch.Generator().manual_seed(1)
    tr = {"temperature": torch.tensor(3.0), "spatial_T": torch.tensor(3.0),
          "ranking_scale": torch.tensor(4.0)}
    feats = {k: torch.nn.functional.normalize(torch.randn(4, cfg.embed_dim, generator=gen),
                                              dim=-1) for k in ("pos", "neg", "evidence")}
    images = torch.randn(2, 64, 64, 3, generator=gen)
    out = dense_test_forward(params, cfg, tr, feats, images, flags)
    ref = test_logits_from_features(tr, feats, encode_image_features(params, cfg, images, flags),
                                    flags)
    for a, b in zip(out, ref):
        assert torch.equal(a, b)


def test_quantize_stack_on_device_under_a_mesh_is_replicated():
    """``quantize_stack_on_device(mesh=)``: the same codes and scales as
    without a mesh (world 1; the broadcast from rank 0 is held across ranks
    by the int8 engine of tests/test_torch_multigpu.py)."""
    from leclip_tpu_torch.models.transformer import init_block_stack
    from leclip_tpu_torch.ops.quant import quantize_stack_on_device

    blocks = init_block_stack(torch.Generator().manual_seed(0), 2, 64, device="cpu")
    plain = quantize_stack_on_device(blocks)
    meshed = quantize_stack_on_device(blocks, mesh=M.local_mesh("cpu"))

    def leaves(t):
        if isinstance(t, dict):
            t = list(t.values())
        return [x for v in t for x in leaves(v)] if isinstance(t, (list, tuple)) else [t]

    assert all(torch.equal(a, b) for a, b in zip(leaves(plain), leaves(meshed)))
    assert len(leaves(plain)) == len(leaves(meshed)) > 4
