"""shell/app (the CLI) of the PyTorch port against the JAX package's, on
the CPU (mirrors tests/test_shell.py and the serve CLI tests of
tests/test_serve.py).

Every port command runs with --cpu; the JAX CLI runs under
JAX_PLATFORMS=cpu. The port's rendered WAVs are held within 1e-5 rel-RMS
of the JAX CLI's on the same files, and the serve process is driven as a
user drives it: started, streamed to, interrupted (it checkpoints) and
restarted on its checkpoint.
"""

import json
import os
import signal
import subprocess
import sys
import threading

import numpy as np
import pytest

from airwave_tpu.shell.app import main as jax_main
from airwave_tpu_torch.io import wav
from airwave_tpu_torch.shell import serve as tserve
from airwave_tpu_torch.shell.app import build_parser, build_serve_pool, main
from airwave_tpu_torch.shell.wire_client import render_via_server
from airwave_tpu_torch.utils.checkpoint import checkpoint_path
from _torch_sigpipe import sigpipe_ignored  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SR = 48_000
TOL = 1e-5
PRESET = "Preamp: -3 dB\nFilter 1: ON PK Fc 100 Hz Gain 2 dB Q 1\n"



def rel_rms(a, ref):
    a, ref = np.asarray(a, np.float64), np.asarray(ref, np.float64)
    return np.sqrt(np.mean((a - ref) ** 2)) / np.sqrt(np.mean(ref ** 2))


def hrir_file(tmp_path, frames=1024, seed=3):
    bank = np.random.default_rng(seed).standard_normal((14, frames)) * 0.05
    bank[:, 0] += 0.8
    path = str(tmp_path / "h.wav")
    wav.save(path, bank.astype(np.float32), SR)
    return path


def input_file(tmp_path, name, channels, frames, seed):
    x = np.random.default_rng(seed).standard_normal((channels, frames)) * 0.2
    path = str(tmp_path / name)
    wav.save(path, x.astype(np.float32), SR)
    return path


def render(cli, capsys, tmp_path, tag, inputs, hrir, eq=None, extra=()):
    args = ["render", "--cpu", *[a for p in inputs for a in ("--input", p)],
            "--hrir", hrir, "--output-dir", str(tmp_path / tag),
            "--block-size", "128", *extra]
    if eq is not None:
        args += ["--eq", eq]
    assert cli(args) == 0
    captured = capsys.readouterr()
    report = json.loads(captured.out)
    return report, [wav.load(p).audio for p in report["rendered"]], captured.err


def test_render_cli_matches_jax_cli_on_both_paths(tmp_path, capsys):
    """`render` on the graph path and with --throughput, two inputs with an
    EQ: each output within 1e-5 of the JAX CLI's on the same files, and the
    two paths agree past the graph path's 20 ms EQ activation ramp
    (tests/test_shell.py:126,413,479)."""
    hrir = hrir_file(tmp_path)
    eq = tmp_path / "p.txt"
    eq.write_text(PRESET)
    inputs = [input_file(tmp_path, f"{n}.wav", 2, 1500, i)
              for i, n in enumerate("ab")]
    outs = {}
    for mode, extra in (("graph", ()), ("throughput", ("--throughput",))):
        report, port, _ = render(main, capsys, tmp_path, f"t-{mode}", inputs,
                                 hrir, str(eq), extra)
        assert report["equalizer"] is True and report["device"] == "cpu"
        if mode == "throughput":
            assert report["profile"]["mode"] == "throughput"
        _, ref, _ = render(jax_main, capsys, tmp_path, f"j-{mode}", inputs,
                           hrir, str(eq), extra)
        for a, b in zip(port, ref):
            assert a.shape == (2, 1500)
            assert rel_rms(a, b) < TOL, mode
        outs[mode] = port
    ramp = 960 + 128  # the 20 ms transition and one block of skew
    for a, b in zip(outs["graph"], outs["throughput"]):
        assert rel_rms(a[:, ramp:], b[:, ramp:]) < TOL


def test_render_cli_714_input_drops_heights(tmp_path, capsys):
    """A 12-channel 7.1.4 input renders through the height-less 14-channel
    map on both paths, and they agree (tests/test_shell.py:154)."""
    hrir = hrir_file(tmp_path)
    inputs = [input_file(tmp_path, "in12.wav", 12, 1024, 4)]
    outs = {}
    for mode, extra in (("graph", ()), ("throughput", ("--throughput",))):
        report, (audio,), _ = render(main, capsys, tmp_path, mode, inputs,
                                     hrir, extra=extra)
        assert report["layout"] == "7.1.4 Atmos"
        assert audio.shape == (2, 1024) and np.any(audio != 0)
        outs[mode] = audio
    assert rel_rms(outs["graph"], outs["throughput"]) < TOL


@pytest.mark.parametrize("preset,extra", [
    ("this is not an EqualizerAPO file\n", ()),
    ("Preamp: -3 dB\nFilter 1: ON PK Fc 40000 Hz Gain 2 dB Q 1\n", ()),
    ("Preamp: -3 dB\nFilter 1: ON PK Fc 40000 Hz Gain 2 dB Q 1\n",
     ("--throughput",)),
], ids=["unparseable", "nyquist-graph", "nyquist-throughput"])
def test_render_cli_failing_eq_is_nonfatal(tmp_path, capsys, preset, extra):
    """A preset that fails to parse or to design warns and the render goes
    on spatial-only (tests/test_shell.py:447,504)."""
    hrir = hrir_file(tmp_path)
    eq = tmp_path / "bad.txt"
    eq.write_text(preset)
    inputs = [input_file(tmp_path, "in.wav", 2, 1024, 2)]
    report, (audio,), err = render(main, capsys, tmp_path, "out", inputs,
                                   hrir, str(eq), extra)
    assert report["equalizer"] is False and "warning" in err
    assert np.isfinite(audio).all() and np.abs(audio).max() > 1e-4


@pytest.mark.parametrize("blocks_per_step", [1, 8])
def test_build_serve_pool_and_client_cli(tmp_path, capsys, blocks_per_step):
    """The serve CLI's pool from the real parser (the ring tier, and the
    paged tier at M=8 with the matching lookahead), behind a server, and
    the `client` subcommand against it (tests/test_serve.py:860,
    tests/test_shell.py:504)."""
    hrir = hrir_file(tmp_path)
    args = build_parser().parse_args([
        "serve", "--cpu", "--hrir", hrir, "--max-streams", "4",
        "--blocks-per-step", str(blocks_per_step)])
    pool, layout = build_serve_pool(args)
    assert layout.name == "Stereo" and str(pool.device) == "cpu"
    assert pool.blocks_per_step == blocks_per_step
    assert pool.renderer.lookahead == blocks_per_step
    n = 2 * 512 + 37
    inp = input_file(tmp_path, "in.wav", 2, n, 17)
    outp = str(tmp_path / "out.wav")
    srv = tserve.RenderServer(pool, port=0)
    srv.start()
    try:
        host, port = srv.address
        rc = main(["client", "--input", inp, "--output", outp,
                   "--host", host, "--port", str(port), "--chunk", "97"])
        assert rc == 0
        report = json.loads(capsys.readouterr().out)
        assert report["rendered_frames"] == n and not report["truncated"]
        direct = render_via_server(srv.address, wav.load(inp).audio, chunk=97)
    finally:
        srv.stop()
    rendered = wav.load(outp).audio
    assert rendered.shape == (2, n) and np.abs(rendered).max() > 1e-4
    np.testing.assert_allclose(rendered, direct, atol=1e-6)


def test_status_cpu_prints_json_and_the_card_is_the_default(capsys):
    assert main(["status", "--cpu"]) == 0
    report = json.loads(capsys.readouterr().out)
    assert report["package"] == "airwave_tpu_torch"
    assert report["device"] == "cpu" and report["devices"][0] == "cpu"
    assert report["native_assembler"] is True
    assert {"torch", "cuda", "data_dir"} <= set(report)
    import torch

    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="is_available"):
            main(["status"])


@pytest.mark.parametrize("flags,item", [
    (["--profile", "{hrir}"], "not both"),
    (["--mesh-devices", "3"], "must divide by --mesh-devices 3"),
], ids=["profile", "mesh-devices"])
def test_unported_serve_flags_exit_cleanly(tmp_path, flags, item):
    """--profile and --mesh-devices are ported (tests/test_torch_grouped.py,
    tests/test_torch_parallel.py) and exit cleanly on the JAX CLI's errors:
    --profile beside --hrir, and a --max-streams (64) that does not divide
    by --mesh-devices."""
    hrir = hrir_file(tmp_path)
    with pytest.raises(SystemExit, match=item):
        main(["serve", "--cpu", "--hrir", hrir,
              *[f.format(hrir=hrir) for f in flags]])


class ServeProcess:
    """`python -m airwave_tpu_torch serve ...` in a child process, its
    stdout lines collected by a reader thread."""

    def __init__(self, args):
        env = dict(os.environ, PYTHONPATH=REPO)
        self.proc = subprocess.Popen(
            [sys.executable, "-m", "airwave_tpu_torch", "serve", *args],
            cwd=REPO, env=env, stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True)
        self.lines = []
        self.listening = threading.Event()
        threading.Thread(target=self._read, daemon=True).start()

    def _read(self):
        for line in self.proc.stdout:
            self.lines.append(json.loads(line))
            if "listening" in self.lines[-1]:
                self.listening.set()

    def ready(self, timeout=120):
        assert self.listening.wait(timeout), self.proc.stderr.read()
        return next(line for line in self.lines if "listening" in line)

    def interrupt(self, timeout=60):
        self.proc.send_signal(signal.SIGINT)
        assert self.proc.wait(timeout) == 0, self.proc.stderr.read()


def test_serve_process_checkpoints_on_interrupt_and_restores(tmp_path):
    """The serve subcommand as a process: it prints its listening line,
    renders a client's stream, writes its checkpoint on Ctrl-C (SIGINT)
    and exits 0; a restart on that checkpoint reports
    restored_checkpoint true."""
    hrir = hrir_file(tmp_path)
    ckpt = str(tmp_path / "serve.ckpt")
    args = ["--cpu", "--hrir", hrir, "--port", "0", "--max-streams", "4",
            "--checkpoint", ckpt, "--checkpoint-interval", "0"]
    first = ServeProcess(args)
    try:
        ready = first.ready()
        assert ready["restored_checkpoint"] is False
        assert ready["device"] == "cpu" and ready["profile_groups"] == 1
        x = (np.random.default_rng(7).standard_normal((2, 700)) * 0.3
             ).astype(np.float32)
        y = render_via_server(tuple(ready["listening"]), x, chunk=256)
        assert y.shape == (2, 700) and np.abs(y).max() > 1e-4
        first.interrupt()
    finally:
        first.proc.kill()
    assert {"checkpoint_saved": ckpt} in first.lines
    assert os.path.exists(checkpoint_path(ckpt))
    second = ServeProcess(args)
    try:
        assert second.ready()["restored_checkpoint"] is True
        second.interrupt()
    finally:
        second.proc.kill()
