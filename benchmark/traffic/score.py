"""The scoring cells' driver: a closed loop of the offline scoring flow.

A pool of seeded JPEGs (COCO's usual sizes, in the shares the cell file
states) is written under TMPDIR. The window runs passes over it, each pass
what ``run_full_inference(save_dir=None)`` does over a test set:
``data/loader.ImageBatcher`` (native decode, bucket sort) in batches of the
CLI's size, into ``TTAEngine.run_batches_fused_staged`` (a producer thread
staging ahead, batches dispatched ahead of the one fetched). An image counts
once its fused scores reached host memory inside the window.

Set-up builds the cell's kernels, makes the weights, members and bank on the
card from the seed, builds the engine and scores one batch of each distinct
shape the passes will send. After the window a sample of the images it
scored, drawn from the seed, is scored again by the plain reference."""

from __future__ import annotations

import gc
import tempfile
import time
from typing import Dict, List

import numpy as np

from .. import harness, program, weights, work
from ..reference import score_ref
from ..reference.clip_ref import FP32
from ..reference.lowprec import CONTROLS

# ----------------------------------- set-up -----------------------------------------


def make_inputs(ctx, seed: int, device, split=None) -> dict:
    """Weights, members, bank and the pool's JPEG bytes from the seed;
    ``split`` collects each one's seconds."""
    cfg, params = ctx.config, ctx.params
    split = {} if split is None else split
    t = time.perf_counter()
    w = weights.make_weights(cfg, harness.sub_seed(seed, "weights"), device)
    members = weights.make_members(cfg, harness.sub_seed(seed, "members"), device)
    ctx.sync()
    split["weights"] = time.perf_counter() - t
    t = time.perf_counter()
    bank = weights.make_bank(cfg["bank_rows"], cfg["embed_dim"],
                             harness.sub_seed(seed, "bank"), device)
    ctx.sync()
    split["bank"] = time.perf_counter() - t
    t = time.perf_counter()
    sizes = weights.image_sizes([tuple(s) for s in params["sizes"]], params["pool_images"])
    blobs = weights.make_jpegs(sizes, harness.sub_seed(seed, "images"), params["jpeg_quality"])
    split["jpegs"] = time.perf_counter() - t
    return {"weights": w, "members": members, "bank": bank, "blobs": blobs}


def one_pass(paths: List[str], batch: int):
    """The batches of one pass over the pool, as ``run_full_inference``
    forms them: (images, their paths)."""
    from leclip_tpu_torch.data.loader import ImageBatcher

    yield from ImageBatcher(paths, batch, sort_by_bucket=True)


def batch_key(images) -> tuple:
    from leclip_tpu_torch.inference.tta import pick_bucket

    sizes = tuple(im.shape[:2] for im in images)
    return pick_bucket(max(s[0] for s in sizes), max(s[1] for s in sizes)), sizes


def setup(ctx, seed: int) -> dict:
    t = time.perf_counter()
    split = {"kernel build": 0.0}
    st = {"build_s": program.build_kernels(ctx.params["route"], ctx.device), "split": split}
    split["kernel build"] = time.perf_counter() - t
    inputs = make_inputs(ctx, seed, ctx.device, split)
    st.update(inputs)
    st["tmp"] = tempfile.TemporaryDirectory(prefix="bench-score-")
    st["paths"] = weights.write_pool(inputs["blobs"], st["tmp"].name)
    t = time.perf_counter()
    st["engine"] = program.build_engine(ctx.config, inputs["weights"], inputs["members"],
                                        inputs["bank"], ctx.device)
    ctx.sync()
    split["engine"] = time.perf_counter() - t
    # one batch of each distinct bucket and size list a pass sends: every
    # shape of the window, and no other
    t = time.perf_counter()
    seen = {}
    for images, _ in one_pass(st["paths"], ctx.params["batch_images"]):
        seen.setdefault(batch_key(images), images)
    for _ in st["engine"].run_batches_fused_staged(iter(seen.values()), depth=2,
                                                  stage_ahead=2):
        pass
    ctx.sync()
    if ctx.trace:
        harness.warm_profiler(ctx.torch)
    split["warm-up"] = time.perf_counter() - t
    st["shapes"] = len(seen)
    return st


# ----------------------------------- window -----------------------------------------


class Tracer:
    """The traced run's spans, from the benchmark's side of each call: CUDA
    events around the engine's stages and around the tower's trunk or
    blocks, the host clock around decode and staging."""

    def __init__(self, torch, engine, obs: harness.Obs):
        self.torch, self.engine, self.obs = torch, engine, obs
        self.batches: List[list] = []
        self.current: list = []
        self.restore: list = []

    def _events(self, name, fn):
        torch = self.torch

        def wrapped(*a, **k):
            s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            s.record()
            out = fn(*a, **k)
            e.record()
            self.current.append((name, s, e))
            return out
        return wrapped

    def _host(self, name, fn):
        def wrapped(*a, **k):
            t0 = time.perf_counter()
            with harness.annotate(name):
                out = fn(*a, **k)
            self.obs.add(name, time.perf_counter() - t0)
            return out
        return wrapped

    def install(self):
        from leclip_tpu_torch.models import resnet, vit

        eng = self.engine
        for attr, name in (("_crops", "resize"), ("_features", "image_tower"),
                           ("_retrieve", "retrieval"), ("_score", "score_fuse")):
            setattr(eng, attr, self._events(name, getattr(eng, attr)))
        dispatch = eng.dispatch_staged_fused

        def traced_dispatch(staged):
            self.current = []
            with harness.annotate("dispatch"):
                out = dispatch(staged)
            self.batches.append(self.current)
            return out
        eng.dispatch_staged_fused = traced_dispatch
        eng.stage_batch_fused = self._host("stage", eng.stage_batch_fused)
        fetch = eng._fetch

        def traced_fetch(out):
            with harness.annotate("fetch"):
                return fetch(out)
        eng._fetch = traced_fetch
        for mod, attr, name in ((resnet, "resnet_features", "trunk"),
                                (vit, "run_transformer", "blocks")):
            fn = getattr(mod, attr)
            self.restore.append((mod, attr, fn))
            setattr(mod, attr, self._events(name, fn))

    def uninstall(self):
        for mod, attr, fn in self.restore:
            setattr(mod, attr, fn)
        for attr in ("_crops", "_features", "_retrieve", "_score", "dispatch_staged_fused",
                     "stage_batch_fused", "_fetch"):
            self.engine.__dict__.pop(attr, None)

    def spans(self, n_batches: int):
        for marks in self.batches[:n_batches]:
            for name, s, e in marks:
                self.obs.add(name, s.elapsed_time(e) / 1e3)


def window(ctx, st: dict, seconds: float, trace: bool) -> dict:
    """Score passes over the pool until ``seconds`` have passed; returns the
    batches fetched inside the window with their paths and times."""
    torch = ctx.torch
    engine, params = st["engine"], ctx.params
    obs = harness.Obs()
    order: List[List[str]] = []
    tracer = Tracer(torch, engine, obs) if trace else None

    def batches():
        while True:
            it = one_pass(st["paths"], params["batch_images"])
            while True:
                t0 = time.perf_counter()
                if trace:
                    with harness.annotate("decode"):
                        item = next(it, None)
                else:
                    item = next(it, None)
                if item is None:
                    break
                if trace:
                    obs.add("decode", time.perf_counter() - t0)
                images, paths = item
                order.append(paths)
                yield images

    if tracer:
        tracer.install()
    prof = harness.ProfileWindow(torch) if trace else None
    p0, p1 = params["profile_batches"]
    done = []
    t_start = time.perf_counter()
    deadline = t_start + seconds
    t_last = t_start
    gen = engine.run_batches_fused_staged(batches(), depth=params["depth"],
                                          stage_ahead=params["stage_ahead"])
    try:
        for i, scores in enumerate(gen):
            t = time.perf_counter()
            if t > deadline:
                break
            done.append((order[i], scores))
            t_last = t
            if prof is not None and i + 1 == p0:
                prof.__enter__()
            elif prof is not None and i + 1 == p1:
                prof.__exit__(None, None, None)
    finally:
        gen.close()
    ctx.sync()
    if prof is not None and prof.result is None and hasattr(prof, "prof"):
        prof.__exit__(None, None, None)
    if tracer:
        tracer.spans(len(done))
        tracer.uninstall()
    return {"done": done, "t_start": t_start, "t_last": t_last, "obs": obs,
            "trace": None if prof is None else prof.result}


# ----------------------------------- checks -----------------------------------------


def sample(done, seed: int, k: int):
    """``k`` distinct pool images scored in the window, drawn from the seed
    in turn from each place of a batch, so that every slot is sampled as
    often as the others (and a fault confined to one slot is), each with
    the scores it got there."""
    by_slot: Dict[int, list] = {}
    for paths, scores in done:
        for slot, (p, row) in enumerate(zip(paths, scores)):
            by_slot.setdefault(slot, []).append((p, row))
    rng = np.random.default_rng(harness.sub_seed(seed, "sample"))
    queues = {s: [c[i] for i in rng.permutation(len(c))] for s, c in sorted(by_slot.items())}
    chosen: Dict[str, np.ndarray] = {}
    while len(chosen) < k and any(queues.values()):
        for queue in queues.values():
            while queue and len(chosen) < k:
                p, row = queue.pop()
                if p not in chosen:
                    chosen[p] = row
                    break
    keys = list(chosen)
    return keys, np.stack([chosen[p] for p in keys])


def score_gap(got: np.ndarray, ref: np.ndarray) -> float:
    """How far the scores [images, classes] lie from the reference's, in
    units of each image's spread of reference scores over the classes, as
    the wider of two medians. The worst class's median over the images of
    |got - ref| sees a scale, an offset, or the routing or fusion of a few
    classes. The second-worst image's median over its classes, each image's
    mean taken out of both sides first, sees a batch slot that answers
    wrong: the sample holds every slot twice. Rounding now and then shifts
    one image's scores as a whole (a bank neighbour of its global crop) and
    tips a fusion threshold, moving an entry or two a long way; no median
    follows either (PERF.md §6, PR 18)."""
    got, ref = got.astype(np.float64), ref.astype(np.float64)
    spread = np.maximum(ref.std(axis=1, keepdims=True), 1e-12)
    classes = np.median(np.abs(got - ref) / spread, axis=0).max()
    centred = (got - got.mean(axis=1, keepdims=True)) - (ref - ref.mean(axis=1, keepdims=True))
    images = np.sort(np.median(np.abs(centred) / spread, axis=1))
    return float(max(images[-min(2, len(images))], classes))


def decode(path_or_blob) -> np.ndarray:
    """The reference's own decode of a pool JPEG (PIL)."""
    import io

    from PIL import Image

    src = io.BytesIO(path_or_blob) if isinstance(path_or_blob, bytes) else path_or_blob
    with Image.open(src) as im:
        return np.asarray(im.convert("RGB"), np.uint8)


def reference_scores(ctx, st: dict, images: List[np.ndarray], num=FP32) -> np.ndarray:
    model = score_ref.build_model(st["weights"], ctx.config, st["members"], st["bank"], num)
    out = score_ref.score_images(images, model, num)
    del model
    ctx.torch.cuda.empty_cache()
    return out


def compared(ctx, st: dict, images: List[np.ndarray], got: np.ndarray, control=None):
    """(name, the program's number, the control's number or None): the
    program's scores and, with ``control``, the lower-precision reference's,
    against the float32 reference's (:func:`score_gap`)."""
    ref = reference_scores(ctx, st, images)
    low = None
    if control is not None:
        low = score_gap(reference_scores(ctx, st, images, control), ref)
    return "score_gap", score_gap(got, ref), low


def free_program(ctx, st: dict) -> None:
    st.pop("engine", None)
    gc.collect()
    ctx.torch.cuda.empty_cache()


# ------------------------------------ run -------------------------------------------


def run(ctx) -> dict:
    torch = ctx.torch
    st = setup(ctx, ctx.seed)
    setup_s = time.perf_counter() - ctx.t0
    harness.log(f"set-up {setup_s:.3f} s (kernel builds {st['build_s']}; "
                f"{st['shapes']} batch shapes warmed); split: "
                + ", ".join(f"{k} {v:.3f} s" for k, v in st["split"].items()))
    res = window(ctx, st, ctx.seconds, ctx.trace)
    done = res["done"]
    n_images = sum(len(p) for p, _ in done)
    elapsed = res["t_last"] - res["t_start"]
    memory = harness.device_info(torch, 1)
    checks = {}
    finite = sum(int(not np.isfinite(s).all()) for _, batch in done for s in batch)
    checks["nonfinite_images"] = harness.check(finite, 0)
    paths, got = sample(done, ctx.seed, ctx.params["sample_images"])
    route = program.engine_route(st["engine"])
    free_program(ctx, st)
    t = time.perf_counter()
    name, gap, _ = compared(ctx, st, [decode(p) for p in paths], got)
    harness.log(f"reference {time.perf_counter() - t:.3f} s for {len(paths)} images")
    checks[name] = harness.check(gap, ctx.params["limits"][name])
    out = {"attempted": n_images, "failed": finite, "checks": checks, "device": memory,
           "e2e": {"images_per_s": n_images / elapsed, "setup_s": setup_s}}
    if ctx.trace:
        obs = res["obs"]
        out["trace"] = res["trace"]
        obs.trace = res["trace"] or {}
        sides = []
        for paths_b, _ in done:
            for p in paths_b:
                sides += list(_sides(*_content(p, st), ctx.config["scales"]))
        obs.work["ideal_s"] = work.score_batch_ideal_s(ctx.config, sides, route)
        obs.work["wall_s"] = elapsed
        if ctx.config["vision_patch_size"]:
            obs.work["blocks_bound_s"] = work.vit_blocks_bound_s(ctx.config, len(sides))
        else:
            obs.work["trunk_bound_s"] = work.rn_trunk_bound_s(ctx.config, len(sides))
        out["obs"] = obs
    st["tmp"].cleanup()
    return out


def _content(path: str, st: dict):
    from PIL import Image

    cache = st.setdefault("sizes", {})
    if path not in cache:
        with Image.open(path) as im:
            cache[path] = (im.size[1], im.size[0])
    return cache[path]


def _sides(h: int, w: int, scales):
    boxes = score_ref.crop_boxes(h, w, scales)
    return boxes[:, 2] - boxes[:, 0]


# ---------------------------------- readings ----------------------------------------


def readings(ctx, seeds: List[int], seconds: float) -> List[dict]:
    """The numbers a limit is set from, at the cell's own size: for each
    seed the program's gap over the sample of a short window, and the
    control's (the reference one precision below the configuration's) over
    the same images, each held against the cell's limit as a run holds it.
    One process, every seed's inputs made anew."""
    torch = ctx.torch
    control = CONTROLS[ctx.params["control"]]
    out = []
    for seed in seeds:
        st = setup(ctx, seed)
        res = window(ctx, st, seconds, False)
        paths, got = sample(res["done"], seed, ctx.params["sample_images"])
        free_program(ctx, st)
        name, prog, low = compared(ctx, st, [decode(p) for p in paths], got, control)
        limit = ctx.params["limits"][name]
        row = {"seed": seed, "images": len(paths), "program": harness.check(prog, limit),
               "control": harness.check(low, limit)}
        harness.log(f"readings {row}")
        out.append(row)
        st["tmp"].cleanup()
        del st
        gc.collect()
        torch.cuda.empty_cache()
    return out
