"""The PyTorch port imports no jax and no module of the JAX package, its
entry points default to the card, and chip_smoke.py refuses to run without
a CUDA card.

Each check runs in a fresh interpreter: after a failed `import
airwave_tpu.ops` the half-initialised airwave_tpu.ops.biquad_design stays
in sys.modules, so a later import of a jax-bound module in the same process
would appear to work.
"""

import ast
import os
import pathlib
import shutil
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

REPO = pathlib.Path(__file__).resolve().parents[1]

BLOCK_JAX = textwrap.dedent("""
    import importlib.abc, sys

    class _NoJax(importlib.abc.MetaPathFinder):
        def find_spec(self, name, path=None, target=None):
            if name == "jax" or name.startswith(("jax.", "jaxlib")):
                raise ImportError(f"jax is blocked: {name}")
            return None

    sys.meta_path.insert(0, _NoJax())
""")


def _run(code: str, cwd=REPO, timeout=120) -> subprocess.CompletedProcess:
    env = dict(os.environ, PYTHONPATH=str(REPO))
    return subprocess.run([sys.executable, "-c", code], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=timeout)


def test_port_imports_and_bakes_with_jax_blocked():
    code = BLOCK_JAX + textwrap.dedent("""
        import importlib, pkgutil
        import numpy as np
        import airwave_tpu_torch

        names = [m.name for m in pkgutil.walk_packages(
            airwave_tpu_torch.__path__, "airwave_tpu_torch.")]
        for name in names:
            importlib.import_module(name)
        for name in ("runtime.stream_pool", "graph.renderer", "native",
                     "shell.app", "shell.serve", "shell.wire_client",
                     "shell.loadgen", "utils.checkpoint", "utils.profiling",
                     "oracle.eq_oracle", "graph.frame_adapter",
                     "graph.eq_processor", "graph.spatial_effect",
                     "graph.effect_graph", "assets.bundled",
                     "assets.hrir_library", "runtime.controller",
                     "runtime.coordinators", "shell.presentation",
                     "tools.convert", "runtime.feeder", "shell.settings",
                     "assets.watcher", "tools.sofa", "tools.spatial",
                     "tools.generate", "tools.plan_capacity",
                     "utils.memory_planner", "parallel.mesh",
                     "parallel.multihost", "ops.biquad_scan", "ops.resample",
                     "tools.soak", "tools.checkpoint_scale",
                     "tools.validate_presets", "__main__"):
            assert "airwave_tpu_torch." + name in names, name

        from airwave_tpu_torch.models.bake import bake
        rng = np.random.default_rng(0)
        hrir = (rng.standard_normal((2, 2, 100)) * 0.3).astype(np.float32)
        x = (rng.standard_normal((2, 2, 200)) * 0.4).astype(np.float32)
        for m in (1, 2):
            y, _ = bake(hrir, x, 48_000.0, block_size=64, blocks_per_step=m,
                        device="cpu")
            assert y.shape == (2, 2, 200) and np.isfinite(y).all()
        assert not any(k == "jax" or k.startswith("jax.") for k in sys.modules)
        print("modules", len(names))
    """)
    proc = _run(code)
    assert proc.returncode == 0, proc.stderr
    assert "modules" in proc.stdout


def test_cli_help_runs_with_jax_blocked():
    """`python -m airwave_tpu_torch --help` (and each subcommand's help)
    runs without jax."""
    code = BLOCK_JAX + textwrap.dedent("""
        import contextlib, io, runpy
        for argv in (["--help"], ["serve", "--help"], ["render", "--help"],
                     ["client", "--help"], ["status", "--help"],
                     ["presets", "--help"], ["demo", "--help"]):
            sys.argv = ["airwave_tpu_torch", *argv]
            out = io.StringIO()
            with contextlib.redirect_stdout(out):
                try:
                    runpy.run_module("airwave_tpu_torch", run_name="__main__")
                except SystemExit as stop:
                    assert stop.code == 0, (argv, stop.code)
            assert "usage: airwave_tpu_torch" in out.getvalue(), argv
        assert not any(k == "jax" or k.startswith("jax.") for k in sys.modules)
        print("help ok")
    """)
    proc = _run(code)
    assert proc.returncode == 0, proc.stderr
    assert "help ok" in proc.stdout


def test_tools_help_runs_with_jax_blocked():
    """`python -m airwave_tpu_torch.tools.{convert,spatial,generate,
    plan_capacity,soak,checkpoint_scale,validate_presets} --help` run
    without jax, and plan_capacity plans."""
    code = BLOCK_JAX + textwrap.dedent("""
        import contextlib, io, json, runpy
        for tool in ("convert", "spatial", "generate", "plan_capacity",
                     "soak", "checkpoint_scale", "validate_presets"):
            sys.argv = [tool, "--help"]
            out = io.StringIO()
            with contextlib.redirect_stdout(out):
                try:
                    runpy.run_module("airwave_tpu_torch.tools." + tool,
                                     run_name="__main__")
                except SystemExit as stop:
                    assert stop.code == 0, (tool, stop.code)
            assert "usage:" in out.getvalue(), tool
        from airwave_tpu_torch.tools.plan_capacity import main
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            assert main(["--blocks-per-step", "8", "--hbm-gb", "24"]) == 0
        assert json.loads(out.getvalue())["max_streams"] > 0
        assert not any(k == "jax" or k.startswith("jax.") for k in sys.modules)
        assert "h5py" not in sys.modules  # read_sofa_hrir imports it lazily
        print("tools ok")
    """)
    proc = _run(code)
    assert proc.returncode == 0, proc.stderr
    assert "tools ok" in proc.stdout


def test_presets_and_demo_run_with_jax_blocked(tmp_path):
    """`presets --cpu seed` and `demo --cpu` run through the port's main
    without jax: the libraries, the controller stack and the render graph."""
    code = BLOCK_JAX + textwrap.dedent(f"""
        import contextlib, io, json
        from airwave_tpu_torch.shell.app import main

        base = ["--data-dir", r"{tmp_path}/data"]
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            assert main([*base, "presets", "--cpu", "seed"]) == 0
        assert "seeded 5 EQ + 3 HRIR" in out.getvalue()
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            assert main([*base, "demo", "--cpu", "--seconds", "0.2",
                         "--eq-preset", "Bass"]) == 0
        report = json.loads(out.getvalue())
        assert report["status"] == "processing" and report["device"] == "cpu"
        assert not any(k == "jax" or k.startswith("jax.") for k in sys.modules)
        print("demo ok")
    """)
    proc = _run(code)
    assert proc.returncode == 0, proc.stderr
    assert "demo ok" in proc.stdout


def test_grouped_pool_and_serve_profile_run_with_jax_blocked(tmp_path):
    """The grouped names (PoolProfile, StreamPool(profiles=...),
    set_renderer and set_equalizer of a group, a grouped snapshot through
    the checkpoint file) and `serve --profile` (its --help, and
    build_serve_pool of two --profile specs) run without jax."""
    code = BLOCK_JAX + textwrap.dedent(f"""
        import contextlib, io, runpy, argparse
        import numpy as np
        from airwave_tpu_torch.assets import channel_maps as cm
        from airwave_tpu_torch.graph.renderer import prepare_renderer
        from airwave_tpu_torch.io import apo, wav
        from airwave_tpu_torch.runtime.stream_pool import (PoolProfile,
                                                           StreamPool)
        from airwave_tpu_torch.shell.app import build_serve_pool
        from airwave_tpu_torch.utils import checkpoint

        rng = np.random.default_rng(0)
        banks = [(rng.standard_normal((14, n)) * 0.2).astype(np.float32)
                 for n in (300, 700)]
        rends = [prepare_renderer(wav.WAVData(48_000.0, a), cm.STEREO,
                                  48_000.0, 64, device="cpu") for a in banks]
        eq = apo.parse(b"Preamp: -2 dB\\n", "e.txt")
        pool = StreamPool(4, 48_000.0, block_size=64, device="cpu",
                          profiles=[PoolProfile(rends[0], eq),
                                    PoolProfile(rends[1])])
        lanes = [pool.attach(0), pool.attach(1)]
        for it in range(3):
            if it == 1:
                assert pool.set_renderer(rends[0], group=1) is True
                pool.set_equalizer(None, group=0)
            pool.push_many(lanes, np.ones((2, 2, 64), np.float32))
            assert pool.pump() == 1
        y = pool.pull_many(lanes, 192)
        assert y.shape == (2, 2, 192) and np.isfinite(y).all()
        path = r"{tmp_path}/grouped"
        checkpoint.save_pool_snapshot(path, pool.snapshot())
        pool.restore(checkpoint.load_pool_snapshot(path, pool))
        assert pool.stats()["attached_per_group"] == [1, 1]

        sys.argv = ["airwave_tpu_torch", "serve", "--help"]
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            try:
                runpy.run_module("airwave_tpu_torch", run_name="__main__")
            except SystemExit as stop:
                assert stop.code == 0
        assert "--profile" in out.getvalue() and "repeatable" in out.getvalue()
        paths = []
        for i, a in enumerate(banks):
            paths.append(r"{tmp_path}/bank%d.wav" % i)
            wav.save(paths[-1], a, 48_000.0)
        args = argparse.Namespace(hrir=None, eq=None, profile=paths,
                                  layout="stereo", sample_rate=48_000.0,
                                  max_streams=4, blocks_per_step=1,
                                  mesh_devices=0, cpu=True, device="cpu")
        grouped, _ = build_serve_pool(args)
        assert grouped.groups == 2
        assert not any(k == "jax" or k.startswith("jax.") for k in sys.modules)
        print("grouped ok")
    """)
    proc = _run(code, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert "grouped ok" in proc.stdout


def test_jax_block_is_effective():
    """The blocker really blocks: the JAX package's ops cannot be imported
    under it (the trap that made the port carry its own biquad_design)."""
    proc = _run(BLOCK_JAX + "import airwave_tpu.ops.biquad_design\n")
    assert proc.returncode != 0
    assert "jax is blocked" in proc.stderr


def _imported_modules(path: pathlib.Path) -> set:
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names.update(a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module)
    return names


def test_chip_smoke_names_no_jax_module():
    """chip_smoke.py imports torch, numpy, scipy and the port only: no jax
    and no module of the JAX package `airwave_tpu`."""
    names = _imported_modules(REPO / "chip_smoke.py")
    roots = {n.split(".")[0] for n in names}
    assert "airwave_tpu_torch" in roots
    assert not roots & {"jax", "jaxlib", "airwave_tpu"}, sorted(names)


def test_port_names_no_jax_package_module():
    """No file of the port imports jax or any module of `airwave_tpu`,
    jax-free or not: the port keeps its own copies of the host modules."""
    files = sorted((REPO / "airwave_tpu_torch").rglob("*.py"))
    assert len(files) > 20
    for path in files:
        roots = {n.split(".")[0] for n in _imported_modules(path)}
        assert not roots & {"jax", "jaxlib", "airwave_tpu"}, path


def _assert_smoke_refused(proc: subprocess.CompletedProcess) -> None:
    assert proc.returncode != 0, proc.stdout
    assert '"ok": true' not in proc.stdout


@pytest.mark.parametrize("argv", [
    [], ["--kernels-only", "--split", "--baseline", "parent=mac_kmajor.cu"]])
def test_chip_smoke_fails_without_cuda(argv):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: chip_smoke.py would run")
    # Run with jax blocked: reaching the CUDA check shows that all of the
    # script's imports load without jax.
    proc = _run(BLOCK_JAX + textwrap.dedent(f"""
        import runpy
        sys.argv = ["chip_smoke.py", *{argv!r}]
        runpy.run_path("chip_smoke.py", run_name="__main__")
    """))
    _assert_smoke_refused(proc)
    assert "torch.cuda.is_available() is False" in proc.stderr


def test_chip_smoke_fails_alone(tmp_path):
    """In a directory holding chip_smoke.py and nothing else of the repo
    it cannot import the port and exits non-zero."""
    shutil.copy(REPO / "chip_smoke.py", tmp_path / "chip_smoke.py")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                          env=env, capture_output=True, text=True, timeout=120)
    _assert_smoke_refused(proc)


def _hrir_wav_and_layout():
    from airwave_tpu_torch.assets import channel_maps
    from airwave_tpu_torch.io.wav import WAVData

    audio = np.random.default_rng(0).standard_normal((14, 100))
    return WAVData(48_000.0, audio.astype(np.float32)), channel_maps.STEREO


def test_entry_points_default_to_the_card():
    """With no device, resolve_device, bake, prepare_renderer, StreamPool,
    DeviceFeeder, device_hbm_bytes and make_mesh ask for the card; where
    there is none they raise and run nothing."""
    from airwave_tpu_torch.device import DEFAULT_DEVICE, resolve_device
    from airwave_tpu_torch.graph.renderer import prepare_renderer
    from airwave_tpu_torch.models.bake import bake
    from airwave_tpu_torch.parallel.mesh import make_mesh
    from airwave_tpu_torch.runtime.feeder import DeviceFeeder
    from airwave_tpu_torch.runtime.stream_pool import StreamPool
    from airwave_tpu_torch.utils.memory_planner import device_hbm_bytes

    assert torch.device(DEFAULT_DEVICE).type == "cuda"
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the defaults would run")
    wav, layout = _hrir_wav_and_layout()
    renderer = prepare_renderer(wav, layout, 48_000.0, 64, device="cpu")
    hrir = np.zeros((2, 2, 100), np.float32)
    x = np.zeros((1, 2, 64), np.float32)
    for call in (resolve_device,
                 lambda: bake(hrir, x, 48_000.0, block_size=64),
                 lambda: prepare_renderer(wav, layout, 48_000.0, 64),
                 lambda: StreamPool(2, 48_000.0, renderer, block_size=64),
                 lambda: StreamPool(2, 48_000.0, block_size=64,
                                    profiles=[(renderer, None)] * 2),
                 lambda: DeviceFeeder(lambda s, x: (s, x), None),
                 device_hbm_bytes, make_mesh):
        with pytest.raises(RuntimeError, match="is_available"):
            call()


def test_resolve_device_never_falls_back():
    from airwave_tpu_torch.device import resolve_device

    assert resolve_device("cpu") == torch.device("cpu")
    with pytest.raises(ValueError):
        resolve_device("meta")
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="is_available"):
        resolve_device("cuda")


def test_precision_policy_is_strict_fp32():
    from airwave_tpu_torch.device import apply_precision_policy, precision_is_strict

    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32,
             torch.get_float32_matmul_precision())
    try:
        torch.backends.cudnn.allow_tf32 = True
        torch.set_float32_matmul_precision("high")
        assert not precision_is_strict()
        apply_precision_policy()
        assert precision_is_strict()
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved[0]
        torch.backends.cudnn.allow_tf32 = saved[1]
        torch.set_float32_matmul_precision(saved[2])
