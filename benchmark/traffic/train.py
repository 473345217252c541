"""The training cells' driver: the caption-distillation trainer's own step,
fed as ``CaptionDistillTrainer.train()`` feeds it.

Set-up makes the text tower's weights on the card and a caption corpus on
the host from the seed (token ids of 5 to 30 words between SOT and EOT, 1 to
4 classes a caption, multi-hot), builds the prompt learner, the optimizer,
the train state and ``engine/trainer.make_train_step`` with the recipe's
options, and drives that one step object through its first steps on the
feed's first batches: those steps warm every shape, and the reference
follows the first three from the seed's inputs. The window then calls the
same step on the same feed (``data/loader.CaptionBatcher``'s epoch
permutations, rows that all differ), fetching the loss at the trainer's
cadence, until the time is up; it keeps a copy of the state before one of
its steps and what the next three did, and the reference follows those
three from that state too."""

from __future__ import annotations

import gc
import itertools
import time
from typing import Dict, List

import numpy as np

from .. import harness, weights, work
from ..reference import clip_ref as C
from ..reference import train_ref
from ..reference.lowprec import CONTROLS

SOT, EOT = 49406, 49407


def make_corpus(rows: int, n_cls: int, context: int, seed: int):
    """(tokens [rows, context] int32, labels [rows, n_cls] float32) from the
    seed: SOT, 5 to 30 random word ids, EOT, zero padding; 1 to 4 distinct
    classes a row."""
    rng = np.random.default_rng(seed)
    lengths = rng.integers(5, 31, rows)
    tokens = rng.integers(1, SOT, (rows, context), dtype=np.int32)
    pos = np.arange(context)[None, :]
    tokens[:, 0] = SOT
    tokens[pos == lengths[:, None] + 1] = EOT
    tokens[pos > lengths[:, None] + 1] = 0
    k = rng.integers(1, 5, rows)
    order = np.argsort(rng.random((rows, n_cls)), axis=1)
    labels = np.zeros((rows, n_cls), np.float32)
    np.put_along_axis(labels, order[:, :4], (np.arange(4)[None, :] < k[:, None]).astype(
        np.float32), axis=1)
    return tokens, labels


def make_inputs(ctx, seed: int) -> dict:
    cfg, params = ctx.config, ctx.params
    w = weights.make_weights(cfg, harness.sub_seed(seed, "weights"), ctx.device, parts=("text",))
    member = {"name": "train", "evidence": False, "n_ctx": params["n_ctx"]}
    trainable = weights.make_members(dict(cfg, members=[member]),
                                     harness.sub_seed(seed, "members"), ctx.device)["train"]
    tokens, labels = make_corpus(params["corpus_rows"], len(cfg["classnames"]),
                                 cfg["context_length"], harness.sub_seed(seed, "corpus"))
    return {"weights": w, "trainable": trainable["trainable"], "tokens": tokens,
            "labels": labels}


def build_step(ctx, inputs: dict, seed: int):
    """(train step, state, feed, steps per epoch): the trainer's step and its
    SGD state on the benchmark's weights and context vectors."""
    import torch
    from leclip_tpu_torch.data.loader import CaptionBatcher
    from leclip_tpu_torch.engine.config import default_config
    from leclip_tpu_torch.engine.train_state import build_optimizer, create_train_state
    from leclip_tpu_torch.engine.trainer import make_train_step
    from leclip_tpu_torch.models.dense_clip import DenseFlags
    from leclip_tpu_torch.models.prompt import build_prompt_learner

    from ..program import clip_config

    cfg, p = ctx.config, ctx.params
    conf = default_config()
    for section, values in p["recipe_config"].items():
        node = getattr(conf, section)
        for key, value in values.items():
            setattr(node, key, type(getattr(node, key))(value))
    clip_cfg = clip_config(cfg)
    clip_params = {"text": inputs["weights"]["text"]}
    trainable, constants = build_prompt_learner(
        torch.Generator(device=ctx.device).manual_seed(0), clip_params, cfg["classnames"],
        n_ctx=p["n_ctx"])
    trainable = {k: inputs["trainable"][k].clone() for k in trainable}
    batcher = CaptionBatcher(inputs["tokens"], inputs["labels"],
                             batch_size=conf.DATALOADER.BATCH_SIZE_TRAIN,
                             seed=harness.sub_seed(seed, "batcher") % (2 ** 32))
    steps = batcher.steps_per_epoch()
    optimizer = build_optimizer(conf.OPTIM, steps)
    state = create_train_state(trainable, optimizer)
    flags = DenseFlags(use_evidence=conf.TRAINER.use_evidence,
                       spatial_scale_text=float(conf.TRAIN.spatial_SCALE_text))
    step = make_train_step(clip_params, clip_cfg, constants, optimizer, flags,
                           loss_name=conf.TRAIN.LOSSFUNC, model_kind=conf.TRAIN.MODEL,
                           ema=conf.TRAIN.ema, momentum=conf.TRAIN.momentum,
                           caption_text=clip_params["text"])
    feed = itertools.chain.from_iterable(batcher.epoch(e) for e in itertools.count())
    return step, state, feed, conf


def _copy(tree: Dict) -> Dict:
    return {k: v.detach().clone() for k, v in tree.items()}


def snapshot(state) -> dict:
    """The program's training state as the reference starts from it: the
    parameters, their EMA twin and SGD's momentum trace."""
    return {"params": _copy(state.params), "ema": _copy(state.ema_params),
            "trace": _copy(state.opt_state["1"]["trace"])}


class Record:
    """Three steps of the program as the comparison reads them: the state
    before the first, each step's batch and loss, the momentum trace after
    the first and the parameters after the third."""

    def __init__(self, start: dict):
        self.start, self.batches, self.losses = start, [], []
        self.trace1 = self.params3 = None

    def add(self, state, batch, metrics) -> None:
        self.batches.append(batch)
        self.losses.append(metrics["loss"].detach().clone())
        if len(self.batches) == 1:
            self.trace1 = _copy(state.opt_state["1"]["trace"])
        elif len(self.batches) == 3:
            self.params3 = _copy(state.params)

    def done(self) -> bool:
        return len(self.batches) == 3


def setup(ctx, seed: int) -> dict:
    t = time.perf_counter()
    st = make_inputs(ctx, seed)
    ctx.sync()
    split = {"weights and corpus": time.perf_counter() - t}
    t = time.perf_counter()
    step, state, feed, conf = build_step(ctx, st, seed)
    split["step"] = time.perf_counter() - t
    t = time.perf_counter()
    st.update(step=step, feed=feed, print_freq=max(conf.TRAIN.PRINT_FREQ, 1))
    # the reference starts from the seed's context vectors, not the program's copy
    params = {k: st["trainable"][k] for k in state.params}
    st["setup"] = Record({"params": params, "ema": params,
                          "trace": {k: ctx.torch.zeros_like(v) for k, v in params.items()}})
    # a traced run's steps take the mark callback, in set-up too
    marks = Marks(ctx.torch) if ctx.trace else None
    for _ in range(ctx.params["setup_steps"]):
        batch = next(feed)
        if marks is not None:
            marks.begin()
        state, metrics = step(state, batch["img"], batch["label"], marks)
        if not st["setup"].done():
            st["setup"].add(state, batch, metrics)
    ctx.sync()
    if ctx.trace:
        harness.warm_profiler(ctx.torch)
    split["first steps"] = time.perf_counter() - t
    st["state"], st["split"] = state, split
    return st


class Marks:
    """CUDA events at the start of each step and at each of its marks."""

    def __init__(self, torch):
        self.torch = torch
        self.steps: List[list] = []

    def event(self):
        ev = self.torch.cuda.Event(enable_timing=True)
        ev.record()
        return ev

    def begin(self):
        self.steps.append([("start", self.event())])

    def __call__(self, name: str):
        self.steps[-1].append((name, self.event()))

    def spans(self, obs: harness.Obs):
        groups = {"caption_branch": ("caption",), "loss_teacher": ("teacher", "loss"),
                  "prompt_branch": ("prompt forward", "backward"), "optimizer": ("optimizer",)}
        for marks in self.steps:
            d = {}
            for (_, a), (name, b) in zip(marks, marks[1:]):
                d[name] = a.elapsed_time(b) / 1e3
            for span, names in groups.items():
                obs.add(span, sum(d.get(n, 0.0) for n in names))


def window(ctx, st: dict, seconds: float, trace: bool) -> dict:
    """Steps until ``seconds`` have passed, and at least until the three
    steps from ``window_check_step`` on are recorded (``st["window"]``)."""
    step, feed, state = st["step"], st["feed"], st["state"]
    obs = harness.Obs()
    marks = Marks(ctx.torch) if trace else None
    prof = harness.ProfileWindow(ctx.torch) if trace else None
    p0, p1 = ctx.params["profile_steps"]
    check = ctx.params["window_check_step"]
    losses = []
    n = 0
    t_start = time.perf_counter()
    deadline = t_start + seconds
    while time.perf_counter() < deadline or n < check + 3:
        if prof is not None and n == p0:
            prof.__enter__()
        if n == check:
            st["window"] = Record(snapshot(state))
        t0 = time.perf_counter()
        if trace:
            with harness.annotate("batch fetch"):
                batch = next(feed)
            obs.add("batch_fetch", time.perf_counter() - t0)
            marks.begin()
            with harness.annotate("step"):
                state, metrics = step(state, batch["img"], batch["label"], marks)
        else:
            batch = next(feed)
            state, metrics = step(state, batch["img"], batch["label"])
        if check <= n < check + 3:
            st["window"].add(state, batch, metrics)
        n += 1
        if n % st["print_freq"] == 0:
            with harness.annotate("metrics fetch"):
                losses.append(float(metrics["loss"]))
        if prof is not None and n == p1:
            prof.__exit__(None, None, None)
    ctx.sync()
    t_end = time.perf_counter()
    losses.append(float(metrics["loss"]))
    if prof is not None and prof.result is None and hasattr(prof, "prof"):
        prof.__exit__(None, None, None)
    if marks is not None:
        marks.spans(obs)
    st["state"] = state
    return {"steps": n, "t_start": t_start, "t_end": t_end, "losses": losses, "obs": obs,
            "trace": None if prof is None else prof.result}


# ----------------------------------- checks -----------------------------------------


def reference_run(ctx, st: dict, rec: Record, num=C.FP32, rows: float = 1.0):
    """The reference's three steps from ``rec``'s start, on its batches."""
    torch = ctx.torch
    start = rec.start
    tr = train_ref.Trainer(st["weights"]["text"], ctx.config, ctx.params["recipe"],
                           start["params"], num, rows, ema=start["ema"], trace=start["trace"])
    for batch in rec.batches:
        tr.step(torch.as_tensor(batch["img"], device=ctx.device),
                torch.as_tensor(batch["label"], device=ctx.device), ctx.params["recipe"]["lr"])
    return tr


def moved_leaves(ref: train_ref.Trainer) -> List[str]:
    """Leaves whose reference gradient is not nought to rounding: a norm of
    at least a thousandth of the largest leaf's (the median leaf's is 0 here:
    four of the six prompt leaves take no part in this recipe's loss)."""
    norms = {k: float(g.norm()) for k, g in ref.grads[0].items()}
    top = max(norms.values())
    return sorted(k for k, v in norms.items() if v >= 1e-3 * top)


def got_of(rec: Record, momentum: float) -> dict:
    """The program's numbers of a record: its three losses, the first
    gradient as the optimizer took it (the trace after the step less the
    momentum's share of the trace before), the parameters after three."""
    start = rec.start["trace"]
    return {"losses": [float(v) for v in rec.losses],
            "grad1": {k: v.float() - momentum * start[k].float() for k, v in rec.trace1.items()},
            "params3": rec.params3}


def ref_as_got(ref: train_ref.Trainer, start: dict) -> dict:
    """A reference run's numbers in the program's form (for the controls)."""
    wd = ref.recipe["weight_decay"]
    return {"losses": ref.losses,
            "grad1": {k: ref.grads[0][k] + wd * start["params"][k].float() for k in ref.grads[0]},
            "params3": ref.params}


def compare(start: dict, got: dict, ref: train_ref.Trainer) -> Dict[str, float]:
    """The numbers compared over three steps from ``start``: the widest
    relative gap of their losses; by the worst moved leaf, the gap of the
    first gradient's norm as the optimizer took it, against the leaf's
    reference norm; and the gap of the norm of the parameters' change over
    the three, against the length of the path the reference's three steps
    took (the sum of their norms): the ema recipe's x10000 KL term pulls
    steps 2 and 3 back against step 1, so on some seeds the change is a
    small difference of large steps and its own norm no steady yardstick."""
    keys = moved_leaves(ref)
    wd = ref.recipe["weight_decay"]
    p0 = {k: start["params"][k].float() for k in keys}
    ref_grad1 = {k: ref.grads[0][k] + wd * p0[k] for k in keys}
    loss_gap = max(abs(a - b) / abs(b) for a, b in zip(got["losses"], ref.losses))
    grad_gap, _ = train_ref.norm_gaps(got["grad1"], ref_grad1, keys)
    got_change = {k: got["params3"][k].float() - p0[k] for k in keys}
    ref_change = {k: ref.params[k] - p0[k] for k in keys}
    change_gap, _ = train_ref.norm_gaps(got_change, ref_change, keys, ref.path)
    return {"loss_gap": loss_gap, "grad_norm_gap": grad_gap, "change_norm_gap": change_gap}


RECORDS = {"": "setup", "window_": "window"}   # a number's prefix → the steps it reads


def all_numbers(ctx, st: dict, got: Dict[str, dict], **kw) -> Dict[str, float]:
    """Every compared number: set-up's first three steps, from the seed's
    inputs, and three steps of the window, from the program's state there.
    ``got``: each record's numbers in the program's form; ``kw``: a control
    or a fault for the reference."""
    nums = {}
    for prefix, key in RECORDS.items():
        rec = st[key]
        ref = reference_run(ctx, st, rec)
        got_rec = got[key]
        if kw:
            got_rec = ref_as_got(reference_run(ctx, st, rec, **kw), rec.start)
        nums.update({prefix + k: v for k, v in compare(rec.start, got_rec, ref).items()})
    return nums


def checks_of(nums: Dict[str, float], limits: Dict[str, float]) -> Dict[str, dict]:
    return {name: harness.check(nums[name], limit) for name, limit in limits.items()}


def free_program(ctx, st: dict) -> dict:
    """Drop the program's step and state; keep what the comparison reads."""
    momentum = ctx.params["recipe"]["sgd_momentum"]
    got = {key: got_of(st[key], momentum) for key in RECORDS.values()}
    for key in ("step", "state", "feed"):
        st.pop(key, None)
    gc.collect()
    ctx.torch.cuda.empty_cache()
    return got


def run(ctx) -> dict:
    torch = ctx.torch
    st = setup(ctx, ctx.seed)
    setup_s = time.perf_counter() - ctx.t0
    harness.log(f"set-up {setup_s:.3f} s ({ctx.params['setup_steps']} steps); split: "
                + ", ".join(f"{k} {v:.3f} s" for k, v in st["split"].items()))
    res = window(ctx, st, ctx.seconds, ctx.trace)
    elapsed = res["t_end"] - res["t_start"]
    batch = ctx.params["recipe_config"]["DATALOADER"]["BATCH_SIZE_TRAIN"]
    memory = harness.device_info(torch, 1)
    bad = sum(int(not np.isfinite(v)) for v in res["losses"])
    got = free_program(ctx, st)
    t = time.perf_counter()
    nums = all_numbers(ctx, st, got)
    harness.log(f"reference {time.perf_counter() - t:.3f} s for twice 3 steps")
    checks = {"nonfinite_losses": harness.check(bad, 0),
              **checks_of(nums, ctx.params["limits"])}
    out = {"attempted": res["steps"], "failed": bad, "checks": checks, "device": memory,
           "e2e": {"train_captions_per_s": res["steps"] * batch / elapsed, "setup_s": setup_s}}
    if ctx.trace:
        obs = res["obs"]
        obs.trace = res["trace"] or {}
        flops = work.train_step_flops(ctx.config, batch, 2, False)
        obs.work["ideal_s"] = res["steps"] * flops / work.PEAK_FLOPS["fp32"]
        obs.work["wall_s"] = elapsed
        out["obs"], out["trace"] = obs, res["trace"]
    return out


# ---------------------------------- readings ----------------------------------------


def readings(ctx, seeds: List[int], seconds: float) -> List[dict]:
    """For each seed, the program's numbers against the reference (set-up's
    steps, and a window just long enough for its recorded steps), and those
    of the control (the reference with TF32 operands) and of a fault planted
    in the reference (the loss over half the batch), each held against the
    cell's limits as a run holds them. A state left unchanged reads 1 by
    the change's measure."""
    limits = ctx.params["limits"]
    out = []
    for i, seed in enumerate(seeds):
        st = setup(ctx, seed)
        window(ctx, st, 0.0, False)
        got = free_program(ctx, st)
        row = {"seed": seed, "program": checks_of(all_numbers(ctx, st, got), limits)}
        if i < ctx.params.get("control_seeds", 3):
            for name, kw in (("control", {"num": CONTROLS[ctx.params["control"]]}),
                             ("half_batch", {"rows": 0.5})):
                row[name] = checks_of(all_numbers(ctx, st, got, **kw), limits)
                row[name + "_correct"] = all(c["ok"] for c in row[name].values())
        harness.log(f"readings {row}")
        out.append(row)
        del st
        gc.collect()
        ctx.torch.cuda.empty_cache()
    return out
