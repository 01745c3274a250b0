"""The port's device tools on the CPU: tools/soak (scripts/soak_device.py),
tools/checkpoint_scale (scripts/measure_checkpoint_scale.py) and
tools/validate_presets (scripts/validate_presets.py).

The soak and the checkpoint measurement run at CPU-tiny widths with
--cpu (their card runs are chip_smoke.py's soak, steady_capacity and
checkpoint_scale phases and tests/test_torch_cuda.py); without it they
refuse to run where there is no card. The preset gate reads files only: it
is run on the same directories as the JAX script and must print the same
lines and exit with the same code."""

import contextlib
import io
import json
import math
import os
import runpy
import sys

import pytest
import torch

from airwave_tpu_torch.tools import checkpoint_scale, soak, validate_presets

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_VALIDATOR = os.path.join(REPO, "scripts", "validate_presets.py")
# scripts/soak_device.py's result keys (blocks_per_step on the paged tier,
# hrir_seconds when given).
SOAK_KEYS = {"metric", "pass", "seconds", "calls", "blocks", "batch_streams",
             "variant", "sustained_x_realtime", "ms_per_block_mean",
             "ms_per_block_p50", "ms_per_block_p99", "ms_per_block_max",
             "tail_ratio_p99_over_p50", "output_drift_ratio", "device"}
# scripts/measure_checkpoint_scale.py's result keys.
CHECKPOINT_KEYS = {"metric", "batch", "blocks_per_step", "carry_gib",
                   "file_gib", "pump_stall_ms", "materialize_ms", "write_ms",
                   "save_total_ms", "load_ms", "restore_ms",
                   "roundtrip_exact", "device"}
SOAK_ARGS = ["--cpu", "--batch", "4", "--hrir-seconds", "0.01",
             "--blocks-per-call", "8"]


def run_main(main, argv) -> tuple:
    """(exit code, the JSON line) of a tool's main(argv) in process."""
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = main(argv)
    return rc, json.loads(out.getvalue())


@pytest.mark.parametrize("pool_blocks", [1, 2])
def test_soak_passes_with_the_scripts_keys(pool_blocks):
    rc, result = run_main(soak.main, [*SOAK_ARGS, "--seconds", "2",
                                      "--pool-blocks", str(pool_blocks)])
    assert rc == 0 and result["pass"] is True, result
    keys = SOAK_KEYS | {"hrir_seconds"} | (
        {"blocks_per_step"} if pool_blocks > 1 else set())
    assert keys <= set(result), keys - set(result)
    assert result["variant"] == ("paged_id" if pool_blocks > 1 else "ring_id")
    assert result["batch_streams"] == 4 and result["device"] == "cpu"
    # A loaded CPU may fit one call in the window: its length is wall-clock.
    assert result["seconds"] >= 2 and result["calls"] >= 1
    assert result["blocks"] == result["calls"] * 8
    assert 0.5 < result["output_drift_ratio"] < 2.0
    assert result["sustained_x_realtime"] > 0
    assert result["ms_per_block_p50"] <= result["ms_per_block_p99"] \
        <= result["ms_per_block_max"]
    # A CPU tensor runs the kernels' plain versions: nothing is launched.
    assert result["launches"] == {"mac_kmajor": 0, "mac_kmajor_pages": 0}


def test_soak_applies_the_bench_eq_target():
    """build_pool settles the EQ ramp: each group's active cascade is its
    bench EQ (group g's variation), no transition pending, no lane left
    attached; the soak's rounds run that cascade."""
    pool = soak.build_pool(4, 0.01, blocks_per_step=2, groups=2,
                           device="cpu")
    for g, rt in enumerate(pool.eq_runtimes):
        assert rt.active.definition == soak.bench_eq_definition(g)
        assert not rt.is_transitioning and rt.pending_target is None
    assert pool.stats()["attached"] == 0
    assert soak.bench_eq_definition(0).preamp_db == -2.5


@torch.inference_mode()
def _poison(pool, leaf: str) -> None:
    """One NaN written into lane 1 of the pool's carry."""
    state = pool._state
    if leaf == "delay line":
        conv = state.conv
        line = conv.pages[0] if hasattr(conv, "pages") else conv.fdl
        line[0, 0, ..., 1] = float("nan")
    else:
        state.eq.s_to[1, 0, 0] = float("nan")


@pytest.mark.parametrize("pool_blocks,leaf", [(1, "delay line"),
                                              (2, "EQ state")])
def test_soak_fails_on_a_nan_in_the_carry(monkeypatch, pool_blocks, leaf):
    pool = soak.build_pool(4, 0.01, blocks_per_step=pool_blocks,
                           device="cpu")
    _poison(pool, leaf)
    result = soak.soak(pool, soak.device_input(pool), 0.5, 8)
    assert result["pass"] is False
    assert "non-finite checksum" in result["failures"]

    build = soak.build_pool

    def poisoned(*args, **kwargs):
        built = build(*args, **kwargs)
        _poison(built, leaf)
        return built

    monkeypatch.setattr(soak, "build_pool", poisoned)
    rc, line = run_main(soak.main, [*SOAK_ARGS, "--seconds", "0.5",
                                    "--pool-blocks", str(pool_blocks)])
    assert rc == 1 and line["pass"] is False, line


def test_soak_checks_its_arguments():
    pool = soak.build_pool(4, 0.01, blocks_per_step=2, device="cpu")
    with pytest.raises(ValueError, match="multiple of blocks_per_step"):
        soak.make_call(pool, soak.device_input(pool), 3)
    with pytest.raises(SystemExit):
        soak.main([*SOAK_ARGS, "--pool-groups", "2", "--hrir-seconds",
                   "0.01,0.02,0.03"])
    with pytest.raises(ValueError, match="profile-group"):
        soak.build_pool(5, 0.01, groups=2, device="cpu")


@pytest.mark.parametrize("tool,argv", [
    (soak, ["--batch", "4", "--seconds", "0.1"]),
    (checkpoint_scale, ["--batch", "8", "--blocks-per-step", "2"]),
])
def test_tools_need_a_card_unless_told_cpu(tool, argv):
    if torch.cuda.is_available():
        pytest.skip("a card is visible: the tool would run on it")
    with pytest.raises(RuntimeError, match="cuda"):
        tool.main(argv)


@pytest.mark.parametrize("blocks_per_step", [2, 1])
def test_checkpoint_scale_round_trips_exactly(tmp_path, blocks_per_step):
    out = str(tmp_path / "ckpt")
    rc, result = run_main(checkpoint_scale.main, [
        "--cpu", "--batch", "8", "--blocks-per-step", str(blocks_per_step),
        "--hrir-seconds", "0.01", "--rounds", "2", "--out", out])
    assert rc == 0 and result["roundtrip_exact"] is True, result
    assert CHECKPOINT_KEYS <= set(result), CHECKPOINT_KEYS - set(result)
    assert result["batch"] == 8 and result["device"] == "cpu"
    assert result["blocks_per_step"] == blocks_per_step
    # The raw container holds the carry, the debt and a header (< 1 MiB).
    assert result["carry_gib"] <= result["file_gib"] \
        <= result["carry_gib"] + 2**-10
    assert math.isclose(result["save_total_ms"], result["pump_stall_ms"]
                        + result["materialize_ms"] + result["write_ms"],
                        rel_tol=1e-9)
    assert os.listdir(tmp_path) == []  # the file is deleted


def test_checkpoint_scale_flags_a_changed_carry(tmp_path, monkeypatch):
    """A load that changes one bit of the carry fails the round trip: the
    comparison covers every leaf."""
    from airwave_tpu_torch.utils import checkpoint

    load = checkpoint.load_pool_snapshot

    def flipped(path, pool, lanes=None):
        snap = load(path, pool, lanes)
        snap["state"].eq.s_to[0, 0, 0] += 1.0
        return snap

    monkeypatch.setattr(checkpoint, "load_pool_snapshot", flipped)
    rc, result = run_main(checkpoint_scale.main, [
        "--cpu", "--batch", "8", "--blocks-per-step", "2", "--hrir-seconds",
        "0.01", "--out", str(tmp_path / "ckpt")])
    assert rc == 1 and result["roundtrip_exact"] is False
    assert os.listdir(tmp_path) == []


def _validators(argv, monkeypatch, capsys) -> tuple:
    """(port rc, port lines, JAX script rc, JAX script lines) on argv."""
    port_rc = validate_presets.main(argv)
    port = capsys.readouterr().out.splitlines()
    script = runpy.run_path(JAX_VALIDATOR)
    monkeypatch.setattr(sys, "argv", [JAX_VALIDATOR, *argv])
    jax_rc = script["main"]()
    return port_rc, port, jax_rc, capsys.readouterr().out.splitlines()


def test_preset_validator_matches_the_scripts_gate(tmp_path, monkeypatch,
                                                   capsys):
    """tests/test_aux_subsystems.py:141's case on the port: a converted
    SOFA validates (rc 0), a corrupted WAV fails with "sha256 mismatch"
    (rc 1); the environment hooks; an EQ directory with a bad preset.
    scripts/validate_presets.py gives the same exit codes and lines."""
    from airwave_tpu_torch.tools.convert import convert_file
    from tests.test_tools import FULL_RING, write_sofa

    out = tmp_path / "out"
    convert_file(write_sofa(tmp_path / "a.sofa", FULL_RING), str(out))
    argv = ["--hrir-dir", str(out), "--expected-count", "1"]
    got = _validators(argv, monkeypatch, capsys)
    assert got == (0, ["presets valid"], 0, ["presets valid"])

    monkeypatch.setenv("AIRWAVE_HRIR_VALIDATION_DIR", str(out))
    monkeypatch.setenv("AIRWAVE_EXPECTED_HRIR_COUNT", "2")
    port_rc, port, jax_rc, jax = _validators([], monkeypatch, capsys)
    assert (port_rc, jax_rc) == (1, 1) and port == jax
    assert port == ["INVALID: expected 2 WAVs, found 1",
                    "INVALID: expected 2 manifests, found 1"]
    monkeypatch.delenv("AIRWAVE_HRIR_VALIDATION_DIR")
    monkeypatch.delenv("AIRWAVE_EXPECTED_HRIR_COUNT")

    wav_path = out / "a.wav"
    blob = bytearray(wav_path.read_bytes())
    blob[-4] ^= 0xFF
    wav_path.write_bytes(bytes(blob))
    port_rc, port, jax_rc, jax = _validators(["--hrir-dir", str(out)],
                                             monkeypatch, capsys)
    assert (port_rc, jax_rc) == (1, 1) and port == jax
    assert port == ["INVALID: a.wav: manifest sha256 mismatch"]

    eq_dir = tmp_path / "eq"
    eq_dir.mkdir()
    (eq_dir / "good.txt").write_text("Preamp: -3 dB\nFilter 1: ON PK Fc 100 "
                                     "Hz Gain 2 dB Q 0.7\n")
    (eq_dir / "bad.txt").write_bytes(b"\xff\xfe\x00garbage")
    port_rc, port, jax_rc, jax = _validators(["--eq-dir", str(eq_dir)],
                                             monkeypatch, capsys)
    assert (port_rc, jax_rc) == (1, 1) and port == jax
    assert len(port) == 1 and port[0].startswith("INVALID: bad.txt: ")


def test_preset_validator_takes_no_device(capsys):
    with pytest.raises(SystemExit) as stop:
        validate_presets.main(["--eq-dir", ".", "--device", "cpu"])
    assert stop.value.code == 2
    with pytest.raises(SystemExit):
        validate_presets.main([])
    assert "provide --hrir-dir and/or --eq-dir" in capsys.readouterr().err
