"""The port's offline tools (tools/sofa, convert, spatial, generate) against
the JAX package's.

Every case of tests/test_tools.py runs twice: once as written, and once on
a copy of that file's source whose imports name airwave_tpu_torch, so the
same test body drives the port's modules (its assertions hold for both).
During each run the module-level `convert`, `spatial`, `wav_io` and
`read_sofa_hrir` the cases call are wrapped to record every return value,
and afterwards every file the case wrote and everything it printed are
read back. Both packages run the same numpy code, so the records, the
files (WAVs byte for byte, manifests with the run's directory replaced by
a placeholder) and the printed JSON must be equal bit for bit. The SOFA
fixtures are written with h5py, as in the JAX file; h5py stays a lazy
import inside read_sofa_hrir in both packages.
"""

import dataclasses
import inspect
import os
import signal
import types

import numpy as np
import pytest

_SOURCE = os.path.join(os.path.dirname(__file__), "test_tools.py")
_WRAPPED = ("convert", "spatial", "wav_io", "read_sofa_hrir")


def _cases_module(root: str) -> types.ModuleType:
    """tests/test_tools.py's cases, bound to the `root` package."""
    with open(_SOURCE) as f:
        source = f.read()
    if root != "airwave_tpu":
        source = source.replace("from airwave_tpu.", f"from {root}.")
    module = types.ModuleType(f"_test_tools_on_{root}")
    module.__file__ = _SOURCE
    exec(compile(source, _SOURCE, "exec"), module.__dict__)
    return module


MODULES = {"jax": _cases_module("airwave_tpu"),
           "torch": _cases_module("airwave_tpu_torch")}


def _norm(value, root: str):
    """A comparable record of a returned value: arrays as dtype, shape and
    bytes, floats by their exact hex, the run's directory as <tmp>."""
    if isinstance(value, (np.ndarray, np.generic)):
        arr = np.asarray(value)
        return ("array", arr.dtype.str, arr.shape, arr.tobytes())
    if isinstance(value, bool) or value is None or isinstance(value, int):
        return value
    if isinstance(value, float):
        return ("float", value.hex())
    if isinstance(value, str):
        return value.replace(root, "<tmp>")
    if isinstance(value, dict):
        return {_norm(k, root): _norm(v, root) for k, v in value.items()}
    if isinstance(value, (list, tuple)):
        return [type(value).__name__] + [_norm(v, root) for v in value]
    if dataclasses.is_dataclass(value):
        return (type(value).__name__,
                {f.name: _norm(getattr(value, f.name), root)
                 for f in dataclasses.fields(value)})
    return (type(value).__name__, _norm(vars(value), root))


class _Recorded:
    """A module (or function) whose calls append (name, record of the
    return value) to `log`."""

    def __init__(self, target, name: str, log: list, root: str) -> None:
        self._target, self._name, self._log, self._root = (target, name, log,
                                                           root)

    def __call__(self, *args, **kwargs):
        out = self._target(*args, **kwargs)
        self._log.append((self._name, _norm(out, self._root)))
        return out

    def __getattr__(self, attr: str):
        value = getattr(self._target, attr)
        if callable(value) and not isinstance(value, type):
            return _Recorded(value, f"{self._name}.{attr}", self._log,
                             self._root)
        return value


def _files(directory: str) -> dict:
    out = {}
    for base, _, names in os.walk(directory):
        for name in names:
            path = os.path.join(base, name)
            with open(path, "rb") as f:
                data = f.read()
            if name.endswith(".json"):
                data = data.replace(directory.encode(), b"<tmp>")
            out[os.path.relpath(path, directory)] = data
    return out


def _run(module, name: str, directory, capsys):
    """Run one case on `module`'s package in `directory`; returns its
    records, what it printed and the files it wrote."""
    root = str(directory)
    log = []
    saved = {g: module.__dict__[g] for g in _WRAPPED}
    for g in _WRAPPED:
        module.__dict__[g] = _Recorded(saved[g], g, log, root)
    fn = module.__dict__[name]
    kwargs = {"tmp_path": directory, "capsys": capsys}
    # The JAX tools' main() resets SIGPIPE to the default, which would make
    # a later socket test in this worker die on a peer close.
    sigpipe = signal.getsignal(signal.SIGPIPE)
    try:
        fn(**{k: kwargs[k] for k in inspect.signature(fn).parameters})
    finally:
        module.__dict__.update(saved)
        signal.signal(signal.SIGPIPE, sigpipe)
    printed = capsys.readouterr().out.replace(root, "<tmp>")
    return log, printed, _files(root)


def _params():
    out = []
    for name, fn in sorted(vars(MODULES["jax"]).items()):
        if not name.startswith("test_") or not callable(fn):
            continue
        marks = [m for m in getattr(fn, "pytestmark", []) if m.name == "heavy"]
        out.append(pytest.param(name, id=name[len("test_"):],
                                marks=[pytest.mark.heavy] if marks else []))
    return out


CASES = _params()


def test_every_case_of_the_jax_file_is_paired():
    assert len(CASES) == 26


@pytest.mark.parametrize("name", CASES)
def test_tool_case_matches_jax(name, tmp_path, capsys):
    runs = {}
    for pkg, module in MODULES.items():
        directory = tmp_path / pkg
        directory.mkdir()
        runs[pkg] = _run(module, name, directory, capsys)
    (jlog, jout, jfiles), (tlog, tout, tfiles) = runs["jax"], runs["torch"]
    assert [n for n, _ in tlog] == [n for n, _ in jlog]
    for (call, want), (_, got) in zip(jlog, tlog):
        assert got == want, call
    assert tout == jout
    assert sorted(tfiles) == sorted(jfiles)
    for rel in jfiles:
        assert tfiles[rel] == jfiles[rel], rel


def test_port_tool_main_leaves_sigpipe_alone(tmp_path, capsys):
    """The port's main() keeps the process's SIGPIPE disposition (only the
    tools' `__main__` entry resets it), where the JAX tools' main() resets
    it to the default."""
    wav = tmp_path / "bank.wav"
    bank = MODULES["torch"].make_bank(frames=1024)
    MODULES["torch"].wav_io.save(str(wav), bank.T.astype(np.float32), 48_000)
    before = signal.getsignal(signal.SIGPIPE)
    try:
        for pkg, changed in (("torch", False), ("jax", True)):
            signal.signal(signal.SIGPIPE, signal.SIG_IGN)
            assert MODULES[pkg].spatial.main([str(wav)]) == 0
            capsys.readouterr()
            assert (signal.getsignal(signal.SIGPIPE)
                    == signal.SIG_DFL) is changed, pkg
    finally:
        signal.signal(signal.SIGPIPE, before)


def test_port_tool_modules_are_the_port_s():
    module = MODULES["torch"]
    for name in ("convert", "spatial", "wav_io"):
        assert module.__dict__[name].__name__.startswith("airwave_tpu_torch.")
    assert module.read_sofa_hrir.__module__ == "airwave_tpu_torch.tools.sofa"
