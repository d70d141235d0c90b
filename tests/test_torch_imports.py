"""PyTorch port, packaging rules: the port and its GPU smoke script import
neither ``jax`` nor the reference package, nothing is built or probed at
import time, and ``device=None`` means the GPU."""
import ast
import importlib
import re
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
ARCH_IDS = ("whisper_tiny", "recurrentgemma_2b", "arctic_480b",
            "qwen3_moe_235b", "stablelm_12b", "nemotron4_15b",
            "phi3_medium_14b", "qwen2_72b", "llava_next_mistral_7b",
            "rwkv6_1b6")
PORT = ROOT / "src" / "repro_torch"
PORT_FILES = sorted(PORT.rglob("*.py"))
SCANNED = PORT_FILES + [ROOT / "chip_smoke.py", ROOT / "rehearse_chip_smoke.py"]
BANNED_ROOTS = {"jax", "jaxlib", "repro", "flax", "optax"}
# Only ever imported inside the function that needs them.
LAZY_ONLY_ROOTS = {"triton"}
KERNEL_SOURCES = ("lk_mvm_fused.cu", "lk_mvm_two_stage.cu",
                  "lk_mvm_stage_left.cu", "lk_mvm_fused_rows.cu", "rbf_gram.cu")


def _imports(path: Path):
    """(root module, is_top_level) for every import statement in a file."""
    tree = ast.parse(path.read_text(), filename=str(path))
    top = set(map(id, tree.body))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0], id(node) in top
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield (node.module or "").split(".")[0], id(node) in top


def _rel(path: Path) -> str:
    return str(path.relative_to(ROOT))


def test_port_has_the_modules_of_this_slice():
    have = {_rel(p) for p in PORT_FILES}
    for mod in ("__init__", "_device", "convert", "core/gp_kernels",
                "core/mvm", "core/transforms", "core/state", "core/engines",
                "core/matheron", "core/posterior", "core/solvers/cg",
                "core/solvers/base", "core/errors", "core/priors",
                "core/slq", "core/lbfgs", "kernels/ref", "kernels/_build",
                "kernels/lk_mvm", "kernels/gram", "kernels/ops",
                "kernels/budget", "kernels/autotune",
                "distributed/__init__", "distributed/lkgp_dist",
                "data/curves", "core/caching", "core/polish", "core/lkgp",
                "data/transforms", "data/lcbench", "data/sources",
                "data/__init__", "core/precond", "core/solvers/pcg",
                "core/solvers/sgd", "core/solvers/guarded", "core/cg",
                "testing/__init__", "testing/faults",
                "autotune/__init__", "autotune/predictor", "autotune/sh",
                "autotune/scheduler", "checkpoint/__init__",
                "checkpoint/manager", "serving/__init__", "serving/metrics",
                "serving/store", "serving/batcher", "serving/checkpoint",
                "serving/service", "models/__init__", "models/layers",
                "models/transformer", "baselines/__init__",
                "baselines/curve_transformer", "baselines/pretrain",
                "baselines/evaluate", "train/__init__", "train/optimizers",
                "train/trainer", "train/pipeline", "train/compression",
                "amortize/__init__", "amortize/encoder",
                "amortize/train", "amortize/make_fixture",
                "configs/__init__", "configs/base", "data/tokens",
                "models/rwkv", "models/registry", "models/moe",
                "models/griffin", "models/encdec",
                "launch/__init__",
                "launch/train", "launch/serve", "launch/mesh",
                "launch/dryrun", "launch/hlo_analysis", "launch/roofline",
                "distributed/sharding", "analysis/__init__",
                "analysis/rules", "analysis/runner", "analysis/__main__",
                "analysis/dispatch_audit",
                *(f"configs/{arch}" for arch in ARCH_IDS)):
        assert f"src/repro_torch/{mod}.py" in have
    for src in KERNEL_SOURCES:
        assert (PORT / "kernels" / "csrc" / src).is_file()
    assert (PORT / "amortize" / "fixtures" / "amortizer_d5.npz").is_file()
    assert not (ROOT / "src" / "repro" / "torch").exists()


@pytest.mark.parametrize("path", SCANNED, ids=_rel)
def test_no_jax_and_no_reference_imports(path):
    roots = {root for root, _ in _imports(path)}
    assert not roots & BANNED_ROOTS, f"{_rel(path)} imports {roots & BANNED_ROOTS}"
    lazy_at_top = {r for r, top in _imports(path) if top and r in LAZY_ONLY_ROOTS}
    assert not lazy_at_top, f"{_rel(path)} imports {lazy_at_top} at module level"


def test_kernel_source_calls_no_library_product():
    build = (PORT / "kernels" / "_build.py").read_text()
    assert "compute_90a" in build and "sm_90a" in build
    assert "cpp_extension" not in build
    csrc = PORT / "kernels" / "csrc"
    for name in KERNEL_SOURCES:
        src = (csrc / name).read_text()
        # the source with the headers of csrc/ it includes
        src += "".join((csrc / h).read_text()
                       for h in re.findall(r'#include "(\w+\.cuh)"', src))
        code = "\n".join(ln.split("//")[0] for ln in src.splitlines())
        for banned in ("cublas", "cutlass", "torch/", "ATen", "cudnn"):
            assert banned not in code, f"{name} mentions {banned}"
        assert "__global__" in code and 'extern "C"' in code
        assert "torch/extension.h" not in src
        if name in ("lk_mvm_fused.cu", "lk_mvm_fused_rows.cu",
                    "lk_mvm_two_stage.cu"):
            # K1 and K3: one tensor-core body (K2a beside it in the
            # two-stage source, with its helpers), no FMA main loop left
            assert '#include "lk_mvm_tc.cuh"' in src
            assert "mma.sync.aligned.m16n8k8.row.col.f32.tf32" in code
            assert "mma.sync.aligned.m16n8k16.row.col.f32.bf16" in code
            assert "cvt.rna.tf32.f32" in code and "fmaf" not in code
        if name == "lk_mvm_stage_left.cu":
            # K2b: its own wgmma kernel fed by TMA, sharing no device code
            # with the tensor-core body
            assert '#include "lk_mvm_tc.cuh"' not in src
            assert "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32" in code
            assert "cp.async.bulk.tensor.2d" in code and "mma.sync" not in code


def test_import_works_without_gpu_toolchain_and_pulls_in_no_jax():
    """A fresh interpreter with ``triton`` made unimportable: importing every
    module of the port succeeds, builds nothing, and loads neither jax nor
    the reference package."""
    mods = [".".join(p.relative_to(ROOT / "src").with_suffix("").parts)
            .removesuffix(".__init__") for p in PORT_FILES]
    code = (
        "import sys, importlib\n"
        "sys.modules['triton'] = None\n"
        f"mods = {mods!r}\n"
        "for m in mods: importlib.import_module(m)\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'repro')]\n"
        "assert not bad, bad\n"
        "import repro_torch.kernels._build as b\n"
        "assert not b._LIBS\n"
        "print('imported', len(mods))\n")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, cwd=ROOT,
                          env={"PYTHONPATH": str(ROOT / "src"), "PATH": ""})
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == f"imported {len(mods)}"


def test_build_directory_is_git_ignored():
    ignore = (ROOT / ".gitignore").read_text().split()
    assert "build/" in ignore and "*.so" in ignore and "__pycache__/" in ignore


ENTRY_POINTS = {
    "resolve_device": lambda rt: rt.resolve_device(),
    "fit_batch": lambda rt: rt.core.fit_batch(*_cpu_batch()),
    "posterior_batch": lambda rt: rt.core.posterior_batch(
        rt.core.stack_states([_cpu_state(rt)])),
    "init_params": lambda rt: rt.init_params(4),
    "params_from_numpy": lambda rt: rt.params_from_numpy({}),
    "state_from_reference": lambda rt: rt.state_from_reference({}),
    "posterior": lambda rt: rt.posterior(_cpu_state(rt)),
    "fit": lambda rt: rt.fit(*_cpu_task()),
    "near_singular_problem": lambda rt: importlib.import_module(
        "repro_torch.testing").near_singular_problem(),
    "CurvePredictor": lambda rt: importlib.import_module(
        "repro_torch.autotune").CurvePredictor(_cpu_task()[0], 4),
    "SuccessiveHalvingScheduler": lambda rt: importlib.import_module(
        "repro_torch.autotune").SuccessiveHalvingScheduler(
            _cpu_task()[0], [None] * 5),
    "HyperbandScheduler": lambda rt: importlib.import_module(
        "repro_torch.autotune").HyperbandScheduler(_cpu_task()[0], [None] * 5),
    "FreezeThawScheduler": lambda rt: importlib.import_module(
        "repro_torch.autotune").FreezeThawScheduler(
            _cpu_task()[0], [None] * 5),
    "PredictionService": lambda rt: importlib.import_module(
        "repro_torch.serving").PredictionService(),
    "state_template": lambda rt: importlib.import_module(
        "repro_torch.serving").state_template(3, 4, 4, "float64",
                                              rt.core.LKGPConfig()),
    "ServiceCheckpointer": lambda rt: importlib.import_module(
        "repro_torch.serving").ServiceCheckpointer(_scratch_dir()),
    "make_train_step": lambda rt: importlib.import_module(
        "repro_torch.train").make_train_step(_curve_model()),
    "pretrain": lambda rt: importlib.import_module(
        "repro_torch.baselines").pretrain(_curve_cfg()),
    "eval_lkgp": lambda rt: importlib.import_module(
        "repro_torch.baselines").eval_lkgp(_task(), _task().mask),
    "head_to_head": lambda rt: importlib.import_module(
        "repro_torch.baselines").head_to_head({}, _curve_cfg(), [_task()]),
    "train_amortizer": lambda rt: importlib.import_module(
        "repro_torch.amortize").train_amortizer(),
    "Amortizer.load": lambda rt: importlib.import_module(
        "repro_torch.amortize").Amortizer.load(_fixture()),
    "get_amortizer": lambda rt: _fresh_registry().get_amortizer(5),
    "tree_from_numpy": lambda rt: rt.tree_from_numpy({}),
    "make_serve_steps": lambda rt: importlib.import_module(
        "repro_torch.train").make_serve_steps(_rwkv_model()),
    "init_cache": lambda rt: _rwkv_model().init_cache(1),
    "init_decoder_cache": lambda rt: _decoder_model().init_cache(1, 4),
    "serve_lm": lambda rt: importlib.import_module(
        "repro_torch.launch.serve").serve_lm(
            _decoder_model().cfg, 1, 4, 2),
    "launch.serve decoder": lambda rt: importlib.import_module(
        "repro_torch.launch.serve").main(["--arch", "llava_next_mistral_7b",
                                          "--smoke"]),
    "launch.train decoder": lambda rt: importlib.import_module(
        "repro_torch.launch.train").main(["--arch", "qwen3_moe_235b",
                                          "--smoke"]),
    "launch.train": lambda rt: importlib.import_module(
        "repro_torch.launch.train").main(["--arch", "rwkv6_1b6", "--smoke"]),
    "launch.serve": lambda rt: importlib.import_module(
        "repro_torch.launch.serve").main(["--arch", "rwkv6_1b6", "--smoke"]),
    "launch.serve curves": lambda rt: importlib.import_module(
        "repro_torch.launch.serve").main(["--service", "curves"]),
}


def _rwkv_model():
    from repro_torch.configs import get_smoke_config
    from repro_torch.models import build_model
    return build_model(get_smoke_config("rwkv6_1b6"))


def _decoder_model():
    from repro_torch.configs import get_smoke_config
    from repro_torch.models import build_model
    return build_model(get_smoke_config("qwen3_moe_235b"))


def _task():
    from repro_torch.data import sample_task
    return sample_task(0, n=5, m=4, d=4)


def _curve_cfg():
    from repro_torch.baselines import CurveTransformerConfig
    return CurveTransformerConfig(d_in=4, d_model=8, num_layers=1,
                                  num_heads=2, d_ff=8)


def _curve_model():
    from repro_torch.baselines import build_curve_model
    return build_curve_model(_curve_cfg())


def _fixture():
    return PORT / "amortize" / "fixtures" / "amortizer_d5.npz"


def _fresh_registry():
    am = importlib.import_module("repro_torch.amortize")
    am.clear_amortizer_registry()
    return am


def _scratch_dir():
    """A directory the checkpointer would create: it raises before that."""
    import tempfile
    return str(Path(tempfile.gettempdir()) / "repro_torch_never_created")


def _cpu_task():
    from repro_torch.data import sample_task
    task = sample_task(0, n=5, m=4, d=4)
    return task.X, task.t, task.Y, task.mask


def _cpu_batch():
    from repro_torch.data import sample_suite, stack_suite
    return stack_suite(sample_suite(0, 2, n=5, m=4, d=4))[:4]


def _cpu_state(rt):
    import numpy as np
    from repro_torch.data import sample_task
    task = sample_task(0, n=5, m=4, d=4)
    arrays = {"X": task.X, "t": task.t, "Y": task.Y, "mask": task.mask,
              "x_tf.lo": np.zeros(4), "x_tf.hi": np.ones(4),
              "t_tf.log_t1": 0.0, "t_tf.log_tm": np.log(4.0),
              "y_tf.shift": 1.0, "y_tf.scale": 0.5}
    arrays.update({f"params.{k}": v.numpy()
                   for k, v in rt.init_params(4, device="cpu")._asdict().items()})
    return rt.state_from_reference(arrays, {"backend": "dense"}, device="cpu")


@pytest.mark.parametrize("name", sorted(ENTRY_POINTS))
def test_default_device_is_the_gpu_and_its_absence_raises(name):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; this checks the CPU-only raise")
    rt = importlib.import_module("repro_torch")
    with pytest.raises(RuntimeError, match="CUDA"):
        ENTRY_POINTS[name](rt)


def test_explicit_devices():
    from repro_torch import resolve_device
    assert resolve_device("cpu") == torch.device("cpu")
    assert resolve_device(torch.device("cpu")).type == "cpu"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            resolve_device("cuda")
        with pytest.raises(RuntimeError, match="CUDA"):
            resolve_device("cuda:0")


def test_chip_smoke_imports_nothing_of_the_reference():
    roots = {root for root, _ in _imports(ROOT / "chip_smoke.py")}
    assert "repro_torch" in roots and not roots & BANNED_ROOTS


def test_chip_smoke_refuses_to_run_without_a_gpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; this checks the CPU-only exit")
    proc = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py")],
                          capture_output=True, text=True, cwd=ROOT)
    assert proc.returncode != 0
    assert proc.stdout.strip() == ""
    assert "CUDA" in proc.stderr
