"""The port's CLI (``debias_vision_lang_torch/cli.py``, ``__main__.py``) and
hub (``hub/hub.py``) against the JAX package's, on the CPU.

CLI: the ``measure-bias``, ``train``, ``zero-shot`` and ``serve`` parsers
have the JAX parsers' dests, defaults and choices, plus ``--device``; the
subcommands reach their entry points with the parsed arguments; ``bench``
runs ``benchmarks_torch/bench.py`` with the parsed ``--device``, and exits
naming the script where no checkout holds it; ``download`` exits naming its
ROADMAP entry; ``python -m debias_vision_lang_torch --help`` runs with jax
blocked.  Hub: prompt
tokens bit-equal to JAX ``hub.load``'s from the same ``.pt``; the same shape
checks and messages; a registry name resolves only to a local file, and a
missing one raises without opening a socket.
"""

import argparse
import json
import os
import pathlib
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

from debias_vision_lang_tpu import cli as jcli
from debias_vision_lang_tpu.data.download import PRETRAINED_PROMPTS as J_PROMPTS
from debias_vision_lang_tpu.models.convert import save_debias_prompt_pt as jsave
from debias_vision_lang_torch import cli as tcli
from debias_vision_lang_torch import hub as thub
from debias_vision_lang_torch.hub import hub as thub_mod
from debias_vision_lang_torch.models.convert import load_debias_prompt_pt

torch.set_num_threads(1)

REPO = pathlib.Path(__file__).resolve().parents[1]
REGISTRY_NAME = "ViT-B/16-gender"
REGISTRY_FILE = os.path.basename(J_PROMPTS[REGISTRY_NAME]["url"])


# ---------------------------------------------------------------------------
# CLI
# ---------------------------------------------------------------------------


def _actions(module, adder):
    parser = argparse.ArgumentParser()
    sub = parser.add_subparsers(dest="cmd")
    getattr(module, adder)(sub)
    (p,) = sub.choices.values()
    return {a.dest: (tuple(a.option_strings), a.default, a.choices, a.nargs, a.required,
                     getattr(a.type, "__name__", a.type), type(a).__name__)
            for a in p._actions if a.dest != "help"}


@pytest.mark.parametrize("adder", ["_add_measure", "_add_train", "_add_serve",
                                   "_add_zero_shot"])
def test_parser_matches_jax_plus_device(adder):
    got, want = _actions(tcli, adder), _actions(jcli, adder)
    assert got.pop("device") == (("--device",), "cuda", None, None, False, None,
                                 "_StoreAction")
    assert got == want


def test_help_lists_the_jax_commands(capsys):
    commands = []
    for module in (jcli, tcli):
        with pytest.raises(SystemExit) as exc:
            module.main(["--help"])
        assert exc.value.code == 0
        out = capsys.readouterr().out
        commands.append(out[out.index("positional arguments"):])
    assert commands[0] == commands[1]


@pytest.mark.parametrize("value", ["1", "1000", "0.5", "1.0"])
def test_topn_parse_as_jax(value):
    assert tcli._parse_topn(value) == jcli._parse_topn(value)
    assert type(tcli._parse_topn(value)) is type(jcli._parse_topn(value))


@pytest.mark.parametrize("value", ["0", "2.5", "x"])
def test_topn_rejects_as_jax(value):
    with pytest.raises(argparse.ArgumentTypeError) as got:
        tcli._parse_topn(value)
    with pytest.raises(argparse.ArgumentTypeError) as want:
        jcli._parse_topn(value)
    assert str(got.value) == str(want.value)


_BLOCKED = """
import runpy, sys
for name in ("jax", "jaxlib", "optax", "debias_vision_lang_tpu"):
    sys.modules[name] = None
sys.argv = ["debias_vision_lang_torch", *sys.argv[1:]]
try:
    runpy.run_module("debias_vision_lang_torch", run_name="__main__", alter_sys=True)
finally:
    loaded = [m for m in sys.modules if m.split(".")[0] in ("jax", "debias_vision_lang_tpu")
              and sys.modules[m] is not None]
    assert not loaded, loaded
"""


@pytest.mark.parametrize("argv", [["--help"], ["serve", "--help"],
                                  ["measure-bias", "--help"], ["train", "--help"],
                                  ["bench", "--help"]])
def test_module_help_runs_with_jax_blocked(argv):
    proc = subprocess.run([sys.executable, "-c", _BLOCKED, *argv], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert "usage:" in proc.stdout


@pytest.mark.parametrize("cmd,item", [
    (["download", "bpe"], "ROADMAP.md 'Not to port'")])
def test_unported_commands_exit_naming_their_item(cmd, item):
    with pytest.raises(SystemExit) as exc:
        tcli.main(cmd)
    assert item in str(exc.value.code)


class _Recorder:
    def __init__(self, result=None):
        self.calls, self.result = [], result

    def __call__(self, *args, **kwargs):
        self.calls.append((args, kwargs))
        return self.result


@pytest.mark.parametrize("argv,device", [(["bench", "--device", "cpu"], "cpu"),
                                         (["bench"], "cuda")])
def test_bench_runs_the_port_bench(argv, device, monkeypatch):
    rec = _Recorder()
    monkeypatch.setattr(tcli, "_run_bench", rec)
    tcli.main(argv)
    ((path, args), kwargs), = rec.calls
    assert pathlib.Path(path).resolve() == REPO / "benchmarks_torch" / "bench.py"
    assert args == ["--device", device] and kwargs == {}


def test_bench_without_the_script_exits_naming_it(tmp_path, monkeypatch):
    monkeypatch.setattr(tcli, "__file__", str(tmp_path / "pkg" / "cli.py"))
    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(tcli, "_run_bench", _Recorder())
    with pytest.raises(SystemExit) as exc:
        tcli.main(["bench", "--device", "cpu"])
    assert "benchmarks_torch/bench.py not found" in str(exc.value.code)


@pytest.fixture
def fake_loader(monkeypatch):
    from debias_vision_lang_torch.models import loader

    model, tok = object(), object()
    rec = _Recorder((model, "preprocess", tok, "alias"))
    monkeypatch.setattr(loader, "model_loader", rec)
    return rec, model, tok


def test_serve_reaches_serve_forever(monkeypatch, fake_loader):
    from debias_vision_lang_torch import serve

    loader, model, tok = fake_loader
    rec = _Recorder()
    monkeypatch.setattr(serve, "serve_forever", rec)
    tcli.main(["serve", "--device", "cpu", "--random-weights", "--port", "0",
               "--max-batch", "16", "--dtype", "bfloat16", "--no-warmup",
               "--max-wait-ms", "3"])
    assert loader.calls == [(("openai/CLIP/ViT-B/16",),
                             {"device": "cpu", "pretrained": False})]
    (args, kwargs), = rec.calls
    assert args == (model, tok)
    assert kwargs == {"host": "127.0.0.1", "port": 0, "max_batch": 16,
                      "max_wait_ms": 3.0, "compute_dtype": "bfloat16", "warmup": False,
                      "mesh": None, "auth_token": None, "tls_cert": None,
                      "tls_key": None, "reuse_port": False, "device": "cpu"}


def test_serve_without_vocab_disables_text(monkeypatch, capsys):
    from debias_vision_lang_torch import serve
    from debias_vision_lang_torch.models import loader

    monkeypatch.setattr(loader, "model_loader",
                        _Recorder(("model", "preprocess", None, "alias")))
    rec = _Recorder()
    monkeypatch.setattr(serve, "serve_forever", rec)
    tcli.main(["serve", "--device", "cpu", "--random-weights"])
    assert rec.calls[0][0] == ("model", None)
    assert "text endpoints disabled" in capsys.readouterr().err


def test_measure_bias_reaches_measure_bias(monkeypatch, fake_loader, capsys):
    from debias_vision_lang_torch.eval import measure

    _, model, tok = fake_loader
    rec = _Recorder({"ndkl": {"eq_opp": 0.5}})
    monkeypatch.setattr(measure, "measure_bias", rec)
    tcli.main(["measure-bias", "--device", "cpu", "--random-weights", "--dtype", "int8",
               "--topn", "100", "--n-samples", "7", "--attribute", "race"])
    (args, kwargs), = rec.calls
    assert args == (model, "preprocess", tok) and kwargs["attribute"] == "race"
    assert kwargs["opts"] == {"topn": 100, "batch_size": 256, "engine": "tpu",
                              "dataset": "fairface", "data_path": None, "progress": True,
                              "dtype": "int8", "n_samples": 7}
    assert '"eq_opp": 0.5' in capsys.readouterr().out


@pytest.mark.parametrize("protocol", [False, True])
def test_zero_shot_reaches_zero_shot_accuracy(monkeypatch, fake_loader, capsys, tmp_path,
                                              protocol):
    """Once refused (it exited naming ROADMAP.md queue 1 item 4), zero-shot
    now loads the model on ``--device``, reads the class folders and runs
    ``zero_shot_accuracy`` with the JAX CLI's arguments."""
    from debias_vision_lang_torch.eval import zero_shot

    loader, model, tok = fake_loader
    for name in ("b", "a"):
        (tmp_path / name).mkdir()
        (tmp_path / name / "0.png").write_bytes(b"")
    rec = _Recorder({"top1": 0.5, "top5": 1.0, "n": 2})
    monkeypatch.setattr(zero_shot, "zero_shot_accuracy", rec)
    tcli.main(["zero-shot", "--device", "cpu", "--random-weights", "--dtype", "int8",
               "--data-path", str(tmp_path), "--batch-size", "8"]
              + (["--imagenet-protocol"] if protocol else []))
    assert loader.calls == [(("openai/CLIP/ViT-B/16",),
                             {"device": "cpu", "pretrained": False})]
    (args, kwargs), = rec.calls
    assert args[0] is model and args[1] is tok and args[3] == ["a", "b"]
    assert args[2].batch_size == 8 and args[2].dataset.iat_labels.tolist() == [0, 1]
    assert kwargs.pop("templates", None) == (zero_shot.imagenet_templates() if protocol
                                             else None)
    assert kwargs == {"n_px": 224, "progress": True, "dtype": "int8"}
    assert json.loads(capsys.readouterr().out) == {"top1": 0.5, "top5": 1.0, "n": 2}


def test_train_reaches_run_training(monkeypatch, capsys):
    from debias_vision_lang_torch.train import loop

    rec = _Recorder({"best_ndkl": 0.1})
    monkeypatch.setattr(loop, "run_training", rec)
    tcli.main(["train", "--device", "cpu", "--random-weights", "--epochs", "1",
               "--train-dtype", "bfloat16"])
    (_, kwargs), = rec.calls
    assert kwargs["device"] == "cpu" and kwargs["pretrained"] is False
    assert kwargs["epochs"] == 1 and kwargs["train_dtype"] == "bfloat16"
    assert kwargs["cache_frozen_embeddings"] is True


def test_cli_defaults_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tcli.main(["serve", "--random-weights", "--model", "openai/CLIP/ViT-B/32"])


# ---------------------------------------------------------------------------
# Hub
# ---------------------------------------------------------------------------


def test_available_models_and_registry_as_jax():
    from debias_vision_lang_tpu.hub import available_models

    assert thub.available_models() == available_models() == [REGISTRY_NAME]
    assert thub_mod.PRETRAINED_PROMPTS == J_PROMPTS


def test_load_debias_prompt_pt_reads_the_jax_export(tmp_path):
    from debias_vision_lang_tpu.models.convert import load_debias_prompt_pt as jload

    emb = np.random.default_rng(0).normal(size=(3, 512)).astype(np.float32)
    jsave(emb, str(tmp_path / "p.pt"))
    got = load_debias_prompt_pt(str(tmp_path / "p.pt"))
    assert got.dtype == torch.float32 and got.device.type == "cpu"
    np.testing.assert_array_equal(got.numpy(), jload(str(tmp_path / "p.pt")))


def test_load_local_pt_bit_equal_to_jax(tmp_path):
    from debias_vision_lang_tpu.hub import load as jload

    emb = np.random.default_rng(1).normal(size=(2, 512)).astype(np.float32)
    path = str(tmp_path / "prompts.pt")
    jsave(emb, path)
    jmodel, jpre = jload(path, pretrained_base=False)
    tmodel, tpre = thub.load(path, device="cpu", pretrained_base=False)
    np.testing.assert_array_equal(tmodel.debias_tokens.detach().numpy(),
                                  np.asarray(jmodel.debias_tokens))
    assert tmodel.debias_cfg.num_debias_tokens == jmodel.debias_cfg.num_debias_tokens == 2
    assert tmodel.debias_cfg.hidden_dim == 512 and tpre.n_px == jpre.n_px == 224
    assert {p.device.type for p in tmodel.parameters()} == {"cpu"}


def test_load_local_infers_prompt_count_and_npz(tmp_path):
    emb = np.random.default_rng(2).normal(size=(7, 512)).astype(np.float32)
    np.savez(tmp_path / "p7.npz", emb=emb)
    model, _ = thub.load(str(tmp_path / "p7.npz"), device="cpu", pretrained_base=False)
    assert model.debias_cfg.num_debias_tokens == 7
    np.testing.assert_array_equal(model.debias_tokens.detach().numpy(), emb)


def test_registry_name_loads_the_local_file(tmp_path):
    emb = np.random.default_rng(3).normal(size=(2, 512)).astype(np.float32)
    jsave(emb, str(tmp_path / REGISTRY_FILE))
    model, _ = thub.load(REGISTRY_NAME, device="cpu", download_root=str(tmp_path),
                         pretrained_base=False)
    np.testing.assert_array_equal(model.debias_tokens.detach().numpy(), emb)


def _jax_error(monkeypatch, name, path):
    """The JAX hub's exception for ``name``, its fetch pointed at ``path``."""
    from debias_vision_lang_tpu.hub import hub as jhub

    monkeypatch.setattr(jhub, "fetch_pretrained_prompts", lambda n, root=None: path)
    with pytest.raises(Exception) as exc:
        jhub.load(name, pretrained_base=False)
    return exc


@pytest.mark.parametrize("shape,registry", [((3, 512), True), ((2, 99), True),
                                            ((3, 99), False), ((512,), False)])
def test_shape_checks_raise_the_jax_message(tmp_path, monkeypatch, shape, registry):
    path = str(tmp_path / (REGISTRY_FILE if registry else "bad.pt"))
    jsave(np.zeros(shape, np.float32), path)
    name = REGISTRY_NAME if registry else path
    with pytest.raises(ValueError, match="prompt shape") as got:
        thub.load(name, device="cpu", download_root=str(tmp_path), pretrained_base=False)
    want = _jax_error(monkeypatch, name, path)
    assert want.type is ValueError and str(got.value) == str(want.value)


def test_unknown_name_raises_the_jax_message(monkeypatch):
    with pytest.raises(RuntimeError, match="available models") as got:
        thub.load("nonexistent-model", device="cpu")
    want = _jax_error(monkeypatch, "nonexistent-model", None)
    assert str(got.value) == str(want.value)


def test_missing_registry_file_opens_no_socket(tmp_path, monkeypatch):
    def no_socket(*args, **kwargs):
        raise AssertionError("the hub opened a socket")

    monkeypatch.setattr(socket, "socket", no_socket)
    monkeypatch.setattr(socket, "create_connection", no_socket)
    with pytest.raises(FileNotFoundError) as exc:
        thub.load(REGISTRY_NAME, device="cpu", download_root=str(tmp_path))
    msg = str(exc.value)
    assert str(tmp_path / REGISTRY_FILE) in msg and "downloads nothing" in msg


def test_default_cache_path(monkeypatch, tmp_path):
    monkeypatch.setattr(thub_mod, "CACHE_PATH", tmp_path)
    with pytest.raises(FileNotFoundError, match=str(tmp_path / REGISTRY_FILE)):
        thub.load(REGISTRY_NAME, device="cpu")


def test_load_defaults_to_the_card(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    jsave(np.zeros((2, 512), np.float32), str(tmp_path / "p.pt"))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        thub.load(str(tmp_path / "p.pt"))
