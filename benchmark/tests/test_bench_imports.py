"""Nothing the benchmark runs loads JAX or the JAX package: every module of
the benchmark and every program module its drivers import, loaded in a fresh
interpreter, with the top-level name of each loaded module compared whole
(``leclip_tpu_torch`` begins with ``leclip_tpu``). The reference loads
nothing of the program at all."""

import glob
import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
BENCH = os.path.dirname(HERE)
ROOT = os.path.dirname(BENCH)
BANNED = {"jax", "jaxlib", "flax", "leclip_tpu", "bench", "chip_smoke"}

# the program modules the drivers import inside their functions
PROGRAM = ["leclip_tpu_torch.data.loader", "leclip_tpu_torch.engine.config",
           "leclip_tpu_torch.engine.train_state", "leclip_tpu_torch.engine.trainer",
           "leclip_tpu_torch.inference.pipeline", "leclip_tpu_torch.inference.tta",
           "leclip_tpu_torch.models.clip", "leclip_tpu_torch.models.dense_clip",
           "leclip_tpu_torch.models.prompt", "leclip_tpu_torch.models.resnet",
           "leclip_tpu_torch.models.vit", "leclip_tpu_torch.cli.serve",
           "leclip_tpu_torch.ops._build", "leclip_tpu_torch.runtime.jpeg"]


def loaded_top_level(code: str) -> set:
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=300,
                         env={**os.environ, "USE_FLAX": "0", "JAX_PLATFORMS": "cpu"})
    assert out.returncode == 0, out.stderr[-3000:]
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def modules_of(sub: str):
    for path in sorted(glob.glob(os.path.join(BENCH, sub, "*.py"))):
        name = os.path.basename(path)[:-3]
        if name != "__init__":
            yield f"benchmark.{sub}.{name}".replace("..", ".")


def test_bench_imports_load_no_jax_package():
    mods = (["benchmark.harness", "benchmark.program", "benchmark.weights", "benchmark.work"]
            + list(modules_of("traffic")) + list(modules_of("reference")) + PROGRAM)
    readers = sorted(glob.glob(os.path.join(BENCH, "metrics", "*.py")))
    code = ("import importlib, importlib.util, json, sys\n"
            f"for m in {mods!r}:\n    importlib.import_module(m)\n"
            f"for i, p in enumerate({readers!r}):\n"
            "    s = importlib.util.spec_from_file_location(f'reader{i}', p)\n"
            "    s.loader.exec_module(importlib.util.module_from_spec(s))\n"
            "print(json.dumps(sorted({k.split('.')[0] for k in sys.modules})))")
    top = loaded_top_level(code)
    assert "leclip_tpu_torch" in top and "benchmark" in top
    assert not top & BANNED, sorted(top & BANNED)


def test_bench_reference_loads_nothing_of_the_program():
    mods = list(modules_of("reference"))
    code = ("import importlib, json, sys\n"
            f"for m in {mods!r}:\n    importlib.import_module(m)\n"
            "print(json.dumps(sorted({k.split('.')[0] for k in sys.modules})))")
    top = loaded_top_level(code)
    assert "benchmark" in top
    assert not top & (BANNED | {"leclip_tpu_torch"}), sorted(top & (BANNED | {"leclip_tpu_torch"}))
