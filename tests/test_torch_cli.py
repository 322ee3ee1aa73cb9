"""The port's command line (``nnpde_tpu_torch/exp/cli.py``) against the JAX
package's.

* The two ``build_parser()``s agree option by option on every subcommand
  (dest, default, choices, type, nargs, required), except ``--jet-impl``'s
  names (``xla`` / ``pallas`` / ``pallas-fused`` become ``torch`` /
  ``kernel`` / ``fused``, default ``torch``) and the added ``--device``.
* For every subcommand, the same arguments reach the same configuration:
  both packages' run wrappers and entry points are replaced by recorders
  and the two dispatches compared field by field (nothing trains).
* ``main([...])`` end to end on the CPU (``--device cpu``) for ``poisson``
  and ``ipw1d``: the printed row, the ledger, the checkpoint, and the
  ``--profile`` trace; ``--debug-nans`` turns anomaly mode on for the run
  only.
* ``python -m nnpde_tpu_torch.exp.cli --help`` exits 0 in a fresh process
  that never imports ``jax`` or ``nnpde_tpu``.

Cost: about 16 s alone on one worker.
"""

import dataclasses
import json
import os
import subprocess
import sys

import pytest
import torch

import nnpde_tpu.exp.cli as jcli
import nnpde_tpu_torch.exp.cli as tcli

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JET = {"xla": "torch", "pallas": "kernel", "pallas-fused": "fused"}


def _subparsers(parser):
    act = next(a for a in parser._actions if a.dest == "cmd")
    return act.choices


def _options(sub):
    return {a.dest: a for a in sub._actions if a.dest != "help"}


def _type_name(t):
    return getattr(t, "__name__", repr(t))


@pytest.mark.parametrize("cmd", sorted(_subparsers(jcli.build_parser())))
def test_parsers_agree_option_by_option(cmd):
    """Every option of every subcommand: dest, option strings, default,
    choices, type, nargs and required equal, but for the two stated
    exceptions."""
    jp, tp = _subparsers(jcli.build_parser()), _subparsers(tcli.build_parser())
    assert set(jp) == set(tp)
    jo, to = _options(jp[cmd]), _options(tp[cmd])
    assert set(to) - set(jo) == {"device"}
    assert set(jo) <= set(to)
    dev = to["device"]
    assert dev.default == "cuda" and dev.option_strings == ["--device"]
    for dest, a in jo.items():
        b = to[dest]
        assert a.option_strings == b.option_strings, dest
        assert a.nargs == b.nargs and a.required == b.required, dest
        assert _type_name(a.type) == _type_name(b.type), dest
        if dest == "jet_impl":
            assert [JET[c] for c in a.choices] == list(b.choices)
            assert JET[a.default] == b.default == "torch"
        else:
            assert a.default == b.default, dest
            assert a.choices == b.choices, dest
            assert type(a) is type(b), dest


ARGVS = {
    "poisson": ["--dim", "3", "--method", "WAN", "--ks", "1,2,1", "--resample", "--sampler",
                "sobol", "--compute-dtype", "hybrid", "--wan-reg", "0.5", "--chunk", "7"],
    "ipw1d": ["--n", "3", "--method", "PINN", "--technique", "OG", "--layers", "1,9,1",
              "--lbfgs", "--jet-impl", "pallas-fused"],
    "ipw1d-wan": ["--n", "2", "--technique", "FN", "--v-layers", "1,4,1", "--minimax",
                  "optimistic", "--v-lr", "0.01", "--u-ema", "0.9", "--jet-impl", "pallas"],
    "ipw2d": ["--nx", "2", "--method", "WAN", "--n-test-grid", "3", "--grid-jitter",
              "--jitter-anchors-fixed", "--weights", '{"data": 10.0}', "--lbfgs"],
    "ipw3d": ["--nz", "2", "--method", "DRM", "--no-resample", "--sampler", "uniform",
              "--layers", "3,8,1", "--save-dir", "SAVE"],
    "subspace": ["--problem", "kh", "--k", "3", "--x-max", "10", "--alpha", "5", "--depth",
                 "2", "--save-dir", "SAVE"],
    "qho1d": ["--n", "2", "--lbfgs", "--lbfgs-mode", "replace", "--lbfgs-iters", "9"],
    "qho1d-wan": ["--technique", "OG", "--v-steps", "2", "--minimax", "extragradient"],
    "qho2d": ["--nx", "1", "--ny", "2", "--trainable-energy", "--energy-lr", "1e-4",
              "--energy-variant", "--lr-schedule", "cosine", "--method", "DRM"],
    "kh": ["--alpha", "5", "--methods", "PINN", "WAN", "--technique", "RAW", "--chunk", "50",
           "--save-dir", "SAVE"],
    "kh-floquet": ["--alpha", "4", "--omega", "0.5", "--M", "1", "--n", "1", "--chunk", "9"],
    "sweep": ["qho1d", "--n-values", "1,2", "--epochs", "5", "--save-dir", "SAVE"],
}


class _Recorder:
    """Stands in for a run wrapper, entry point or sweep: records the
    configuration (or the keyword arguments) and returns a minimal output."""

    def __init__(self, calls, name):
        self.calls, self.name = calls, name

    def __call__(self, *args, **kw):
        kw.pop("device", None)
        cfg = args[0] if args else None
        rec = dataclasses.asdict(cfg) if dataclasses.is_dataclass(cfg) else list(args)
        self.calls.append((self.name, type(cfg).__name__, rec, kw))
        row = {"tag": "t", "L2_error": 0.0, "min_epoch": 0, "best_model_path": "p",
               "method": "m", "n": 0, "technique": "x", "E_ref": 0.0, "E_est": 0.0,
               "L2_error_dense": 0.0, "elapsed_time_sec": 0.0}
        if self.name == "run_compare" or self.name.startswith("sweep_"):
            return [row]
        return {"row": row, "rel_l2": 0.0, "min_epoch": 0, "E_exact": 0.0, "checkpoint": "c",
                "eigenvalues": [0.0], "exact": [0.0], "best_epoch": 0, "eps_est": 0.0,
                "eps_ref": 0.0, "eps_avg": 0.0, "harmonic_weights": [1.0]}


def _patch(monkeypatch, pkg, calls):
    import importlib

    run = importlib.import_module(f"{pkg}.exp.run")
    sweeps = importlib.import_module(f"{pkg}.exp.sweeps")
    for name in dir(run):
        if name.startswith("run_"):
            monkeypatch.setattr(run, name, _Recorder(calls, name))
    for name in dir(sweeps):
        if name.startswith("sweep_"):
            monkeypatch.setattr(sweeps, name, _Recorder(calls, name))
    for mod, name in (("subspace", "train_subspace"), ("kh", "run_compare"),
                      ("kh_floquet", "train_kh_floquet")):
        monkeypatch.setattr(importlib.import_module(f"{pkg}.problems.{mod}"), name,
                            _Recorder(calls, name))


def _jet_to_torch(calls):
    for _, _, rec, _ in calls:
        if isinstance(rec, dict) and "jet_impl" in rec:
            rec["jet_impl"] = JET[rec["jet_impl"]]
    return calls


@pytest.mark.parametrize("cmd", sorted(ARGVS))
def test_dispatch_builds_the_same_configurations(cmd, monkeypatch, tmp_path, capsys):
    """The same argv builds the same configuration in both packages (the
    JAX jet names mapped to the port's), with the default and the given
    options."""
    for argv in ([cmd] if cmd != "sweep" else ["sweep", "ipw1d"], [cmd] + ARGVS[cmd]):
        argv = [str(tmp_path) if a == "SAVE" else a for a in argv]
        jcalls, tcalls = [], []
        _patch(monkeypatch, "nnpde_tpu", jcalls)
        _patch(monkeypatch, "nnpde_tpu_torch", tcalls)
        assert jcli.main(argv) == 0
        targv = [JET.get(a, a) for a in argv] + ["--device", "cpu"]
        assert tcli.main(targv) == 0
        assert jcalls and _jet_to_torch(jcalls) == tcalls
        out = capsys.readouterr().out.strip().splitlines()
        assert len(out) % 2 == 0 and out[:len(out) // 2] == out[len(out) // 2:]


def test_main_poisson_and_ipw1d_end_to_end_on_the_cpu(tmp_path, capsys):
    """main() trains on the CPU, prints the row's summary, writes the
    ledger and the checkpoint; --profile writes a trace; --debug-nans holds
    anomaly mode for the run only."""
    save = str(tmp_path / "p")
    assert tcli.main(["poisson", "--epochs", "20", "--chunk", "10", "--n-interior", "128",
                      "--width", "8", "--depth", "3", "--jet-impl", "fused", "--device", "cpu",
                      "--save-dir", save, "--profile", str(tmp_path / "prof"),
                      "--debug-nans"]) == 0
    assert not torch.is_anomaly_enabled()
    row = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert set(row) == {"tag", "L2_error", "min_epoch", "best_model_path"}
    assert row["tag"].startswith("PINN_FBC_d2_ks1-1_") and os.path.exists(row["best_model_path"])
    ledger = json.load(open(os.path.join(save, "results_poisson_nd.json")))
    assert len(ledger) == 1 and ledger[0]["epochs"] == 20
    assert any(f.endswith(".pt.trace.json") for f in os.listdir(tmp_path / "prof"))

    save = str(tmp_path / "i")
    assert tcli.main(["ipw1d", "--n", "2", "--method", "DRM", "--layers", "1,8,8,1",
                      "--epochs", "20", "--chunk", "10", "--jet-impl", "fused",
                      "--device", "cpu", "--save-dir", save]) == 0
    row = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert row["tag"].startswith("DRM_n2_FN_") and row["min_epoch"] >= 0
    assert json.load(open(os.path.join(save, "results_IPW_1D.json")))[0]["method"] == "DRM"


def test_main_without_a_card_raises():
    """The default --device is the card; without one the run refuses."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tcli.main(["poisson", "--epochs", "1"])


def test_help_runs_without_jax():
    """`python -m nnpde_tpu_torch.exp.cli --help` exits 0, and the module
    imports neither jax nor nnpde_tpu."""
    env = dict(os.environ, PYTHONPATH=ROOT)
    r = subprocess.run([sys.executable, "-m", "nnpde_tpu_torch.exp.cli", "--help"], cwd=ROOT,
                       env=env, capture_output=True, text=True, timeout=120)
    assert r.returncode == 0 and "poisson" in r.stdout
    probe = ("import runpy, sys\n"
             "sys.argv = ['cli', 'poisson', '--help']\n"
             "try:\n"
             "    runpy.run_module('nnpde_tpu_torch.exp.cli', run_name='__main__')\n"
             "except SystemExit as e:\n"
             "    code = e.code\n"
             "print(code, 'jax' in sys.modules, 'nnpde_tpu' in sys.modules)\n")
    r = subprocess.run([sys.executable, "-c", probe], cwd=ROOT, env=env, capture_output=True,
                       text=True, timeout=120)
    assert r.returncode == 0 and r.stdout.split()[-3:] == ["0", "False", "False"], r.stderr
