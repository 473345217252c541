"""The port stands alone: nothing under leclip_tpu_torch/ (nor chip_smoke.py)
imports JAX or the JAX package, and every entry point runs on the card
unless the caller asks for the CPU — without a card it raises."""

import ast
import os

import numpy as np
import pytest
import torch

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "msgpack", "leclip_tpu")
# the training slice's modules, which the scans above must cover
TRAINING = ("utils/registry.py", "utils/logging.py", "utils/tb_events.py",
            "engine/metrics.py", "engine/evaluator.py", "data/freq_stats.py",
            "data/labeling.py", "data/corpora.py", "data/datasets.py", "ops/losses.py",
            "engine/train_state.py", "engine/flax_msgpack.py", "engine/checkpoint.py",
            "engine/trainer.py", "cli/train.py")
# the dump path's, the offline CLIs' and the scoring service's modules
DUMP_AND_SERVING = ("inference/tta.py", "inference/pipeline.py", "data/loader.py",
                    "cli/eval.py", "cli/gen_final_ans.py", "cli/parse_results.py",
                    "cli/build_caption_bank.py", "cli/serve.py")
# the adapter trainer, the optimizer menu, the native decoder, zero-shot and
# the caption benchmark
FLOW = ("models/adapter.py", "engine/train_state.py", "runtime/jpeg.py", "ops/crops.py",
        "ops/preprocess.py", "cli/zeroshot.py", "inference/caption_eval.py")
# dual-encoder fine-tuning and the rest of the JAX package's breadth
FINETUNE = ("engine/finetune.py", "models/gcn.py", "models/zoo.py", "ops/randaugment.py",
            "ops/autoaugment.py", "ops/_aa_policies.py", "ops/quant_stress.py",
            "data/synth_images.py", "data/gen_captions.py", "cli/gen_captions.py",
            "data/loader.py", "models/transformer.py")
# the data mesh: one process per GPU over torch.distributed
PARALLEL = ("parallel/__init__.py", "parallel/mesh.py", "parallel/multihost.py",
            "parallel/retrieval.py")


def _port_files():
    out = [os.path.join(ROOT, "chip_smoke.py")]
    for d, _, files in os.walk(os.path.join(ROOT, "leclip_tpu_torch")):
        out += [os.path.join(d, f) for f in files if f.endswith(".py")]
    return sorted(out)


def _imported_roots(path):
    tree = ast.parse(open(path).read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]


def test_port_files_import_no_jax_nor_jax_package():
    files = _port_files()
    assert len(files) > 20 and os.path.exists(files[0])
    bad = [(os.path.relpath(p, ROOT), m) for p in files for m in _imported_roots(p)
           if m in FORBIDDEN]
    assert not bad, bad


def test_port_imports_only_torch_numpy_and_stdlib():
    import sys

    allowed = {"torch", "numpy", "leclip_tpu_torch", "PIL", "yaml"}
    std = set(sys.stdlib_module_names)
    extra = sorted({(os.path.relpath(p, ROOT), m) for p in _port_files()
                    for m in _imported_roots(p) if m not in allowed and m not in std})
    assert not extra, extra


@pytest.fixture()
def no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_entry_points_raise_without_cuda(no_cuda, tmp_path):
    from leclip_tpu_torch.cli.build_caption_bank import main as bank_main
    from leclip_tpu_torch.cli.eval import main as eval_main
    from leclip_tpu_torch.cli.serve import build_service, main as serve_main
    from leclip_tpu_torch.device import resolve_device
    from leclip_tpu_torch.engine.config import setup_config
    from leclip_tpu_torch.inference.pipeline import build_caption_bank, make_engine
    from leclip_tpu_torch.inference.tta import TTAEngine
    from leclip_tpu_torch.models.clip import PRESETS, init_clip_params

    cfg = PRESETS["ViT-TEST"]
    params = init_clip_params(torch.Generator().manual_seed(0), cfg, device="cpu")
    toks = np.zeros((2, 77), np.int32)
    calls = [
        lambda: resolve_device(None),
        lambda: init_clip_params(torch.Generator().manual_seed(0), cfg),
        lambda: init_clip_params(torch.Generator().manual_seed(0), PRESETS["RN-TEST"]),
        lambda: build_caption_bank(params, cfg, toks),
        lambda: TTAEngine(params, cfg, {}),
        lambda: make_engine(setup_config(), params, cfg, {}),
        lambda: eval_main(["--backbone", "ViT-TEST", "--model-dir", str(tmp_path)]),
        lambda: eval_main(["--backbone", "RN-TEST", "--model-dir", str(tmp_path)]),
        lambda: eval_main(["--backbone", "ViT-TEST", "--model-dir", str(tmp_path),
                           "--save-dir", str(tmp_path / "dumps")]),
        lambda: build_service(setup_config(), params, cfg, str(tmp_path)),
        lambda: bank_main(["--backbone", "ViT-TEST", "--caption-root", str(tmp_path),
                           "--corpora", "none"]),
        lambda: serve_main(["--backbone", "ViT-TEST", "--model-dir", str(tmp_path)]),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="CUDA"):
            call()
    # explicit CPU is honoured
    assert resolve_device("cpu").type == "cpu"
    assert build_caption_bank(params, cfg, toks, device="cpu").shape == (2, cfg.embed_dim)


def test_training_modules_are_scanned_and_import_alone():
    import importlib

    files = _port_files()
    for rel in TRAINING:
        path = os.path.join(ROOT, "leclip_tpu_torch", rel)
        assert path in files, rel
        importlib.import_module("leclip_tpu_torch." + rel[:-3].replace("/", "."))


def test_dump_and_serving_modules_are_scanned_and_import_alone():
    import importlib

    files = _port_files()
    for rel in DUMP_AND_SERVING:
        path = os.path.join(ROOT, "leclip_tpu_torch", rel)
        assert path in files, rel
        importlib.import_module("leclip_tpu_torch." + rel[:-3].replace("/", "."))


def test_training_entry_points_raise_without_cuda(no_cuda, tmp_path):
    from leclip_tpu_torch.cli.train import main as train_main
    from leclip_tpu_torch.data.datasets import CaptionDataset
    from leclip_tpu_torch.engine.config import setup_config
    from leclip_tpu_torch.engine.trainer import CaptionDistillTrainer, build_trainer
    from leclip_tpu_torch.models.clip import PRESETS, init_clip_params

    cfg = PRESETS["RN-TEST"]
    params = init_clip_params(torch.Generator().manual_seed(0), cfg, device="cpu")
    ds = CaptionDataset(np.zeros((4, 77), np.int32), np.zeros((4, 80), np.int8), [],
                        ["dog"] * 80)
    tcfg = setup_config(opts=["OUTPUT_DIR", str(tmp_path)])
    for call in (lambda: CaptionDistillTrainer(tcfg, params, cfg, dataset=ds),
                 lambda: build_trainer(tcfg, params, cfg, dataset=ds),
                 lambda: train_main(["--backbone", "RN-TEST", "--output-dir", str(tmp_path)])):
        with pytest.raises(RuntimeError, match="CUDA"):
            call()
    assert CaptionDistillTrainer(tcfg, params, cfg, dataset=ds, device="cpu").device.type == "cpu"


def test_flow_modules_are_scanned_and_import_alone():
    import importlib

    files = _port_files()
    for rel in FLOW:
        path = os.path.join(ROOT, "leclip_tpu_torch", rel)
        assert path in files, rel
        importlib.import_module("leclip_tpu_torch." + rel[:-3].replace("/", "."))


def test_zeroshot_adapter_and_caption_benchmark_raise_without_cuda(no_cuda, tmp_path):
    from leclip_tpu_torch.cli.zeroshot import main as zeroshot_main
    from leclip_tpu_torch.data.datasets import CaptionDataset
    from leclip_tpu_torch.engine.config import setup_config
    from leclip_tpu_torch.engine.trainer import CaptionDistillAdapterTrainer, build_trainer
    from leclip_tpu_torch.inference.caption_eval import score_caption_benchmark
    from leclip_tpu_torch.models.clip import PRESETS, init_clip_params

    cfg = PRESETS["RN-TEST"]
    params = init_clip_params(torch.Generator().manual_seed(0), cfg, device="cpu")
    ds = CaptionDataset(np.zeros((4, 77), np.int32), np.zeros((4, 80), np.int8), [],
                        ["dog"] * 80)
    tcfg = setup_config(opts=["OUTPUT_DIR", str(tmp_path),
                              "TRAINER.NAME", "Caption_distill_double_adapter"])
    for call in (lambda: CaptionDistillAdapterTrainer(tcfg, params, cfg, dataset=ds),
                 lambda: build_trainer(tcfg, params, cfg, dataset=ds),
                 lambda: zeroshot_main(["--backbone", "RN-TEST", "--images-dir", str(tmp_path)]),
                 lambda: score_caption_benchmark(params, cfg, {}, np.zeros((2, 77), np.int32))):
        with pytest.raises(RuntimeError, match="CUDA"):
            call()
    # explicit CPU is honoured
    tr = build_trainer(tcfg, params, cfg, dataset=ds, device="cpu")
    assert isinstance(tr, CaptionDistillAdapterTrainer) and tr.device.type == "cpu"


def test_finetune_modules_are_scanned_and_import_alone():
    import importlib

    files = _port_files()
    for rel in FINETUNE:
        path = os.path.join(ROOT, "leclip_tpu_torch", rel)
        assert path in files, rel
        importlib.import_module("leclip_tpu_torch." + rel[:-3].replace("/", "."))


def test_finetuner_raises_without_cuda(no_cuda):
    from leclip_tpu_torch.engine.finetune import CLIPFineTuner
    from leclip_tpu_torch.models.clip import PRESETS, init_clip_params

    cfg = PRESETS["ViT-TEST"]
    params = init_clip_params(torch.Generator().manual_seed(0), cfg, device="cpu")
    with pytest.raises(RuntimeError, match="CUDA"):
        CLIPFineTuner(params, cfg)
    assert CLIPFineTuner(params, cfg, device="cpu").device.type == "cpu"


def test_parallel_modules_are_scanned_and_import_alone():
    import importlib

    files = _port_files()
    for rel in PARALLEL:
        path = os.path.join(ROOT, "leclip_tpu_torch", rel)
        assert path in files, rel
        importlib.import_module("leclip_tpu_torch." + rel[:-3].replace("/", "."))


def test_parallel_entry_points_raise_without_cuda(no_cuda, monkeypatch, tmp_path):
    """The mesh's device defaults to the card (cuda:LOCAL_RANK): without one
    every way in raises before it joins a group; the CPU is used when asked
    for."""
    import torch.distributed as dist

    from leclip_tpu_torch.parallel import multihost
    from leclip_tpu_torch.parallel.mesh import data_mesh, local_mesh

    calls = [lambda: multihost.local_device(None), lambda: multihost.local_device("cuda"),
             lambda: data_mesh(), lambda: local_mesh(),
             lambda: multihost.initialize(init_method=f"file://{tmp_path}/rdv", world_size=1,
                                          rank=0)]
    for var, value in (("RANK", "0"), ("WORLD_SIZE", "1"), ("MASTER_ADDR", "localhost"),
                       ("MASTER_PORT", "29500"), ("LOCAL_RANK", "0")):
        monkeypatch.setenv(var, value)
    calls.append(lambda: multihost.initialize())
    for call in calls:
        with pytest.raises(RuntimeError, match="CUDA"):
            call()
    assert not dist.is_initialized()
    mesh = data_mesh("cpu")
    assert (mesh.device.type, mesh.rank, mesh.world, mesh.distributed) == ("cpu", 0, 1, False)


def _jax_top_level_names():
    """The keys of the JAX package's table of top-level names."""
    tree = ast.parse(open(os.path.join(ROOT, "leclip_tpu", "__init__.py")).read())
    tables = [n.value for n in ast.walk(tree) if isinstance(n, ast.Assign)
              and any(getattr(t, "id", "") == "table" for t in n.targets)]
    assert len(tables) == 1
    return {k.value for k in tables[0].keys}


def test_top_level_names_resolve_to_port_modules():
    """Every name of the JAX package's table of top-level names is in the
    port's, and each resolves to the object of the port module it names."""
    import importlib

    import leclip_tpu_torch as port

    assert set(port._NAMES) == _jax_top_level_names()
    for name, (module, attr) in port._NAMES.items():
        mod = importlib.import_module(f"leclip_tpu_torch.{module}")
        obj = getattr(port, name)
        assert obj is getattr(mod, attr), name
        assert getattr(obj, "__module__", mod.__name__).startswith("leclip_tpu_torch."), name
    with pytest.raises(AttributeError):
        port.no_such_name  # noqa: B018

