"""The port's bench (``benchmarks_torch/bench.py``, the CLI's ``bench``)
against the root ``bench.py``, and the port's observability helpers
(``debias_vision_lang_torch/utils/observability.py``), on the CPU at a tiny
size.

  * each configuration a-f: the port's ``make_embed`` against the JAX
    function the root ``bench.py`` calls under the same env, recorded while
    its ``main()`` runs on the same weights and its own ``default_rng(0)``
    buffers: float32 within atol 1e-4, bfloat16 and int8 at row cosine >=
    0.999; the port takes the route the card would (``BENCH_PALLAS`` on);
  * the knob table of ``bench.py:89-106``;
  * both benches' JSON lines to one contract, the watchdog's record, the
    refusal without a card, the CLI's ``bench``;
  * ``profile_trace``, ``step_timer``, ``enable_debug_nans``.
"""

import importlib.util
import json
import os
import pathlib
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from debias_vision_lang_tpu.core.config import CLIPConfig, TextConfig, VisionConfig
from debias_vision_lang_torch import cli as tcli
from debias_vision_lang_torch.models import clip as tclip
from debias_vision_lang_torch.models.convert import params_from_jax, to_jax_tree
from debias_vision_lang_torch.ops import attention as tattention
from debias_vision_lang_torch.ops import fused_block as tfb
from debias_vision_lang_torch.ops import fused_block_q as tfbq
from torch_port_config import port_config

torch.set_num_threads(1)

REPO = pathlib.Path(__file__).resolve().parents[1]
JAX_BENCH = REPO / "bench.py"
PORT_BENCH = REPO / "benchmarks_torch" / "bench.py"
CFG = CLIPConfig(
    name="tiny",
    vision=VisionConfig(kind="vit", image_size=32, patch_size=8, width=64,
                        layers=2, heads=2, embed_dim=32),
    text=TextConfig(vocab_size=512, context_length=16, width=32, layers=2,
                    heads=2, embed_dim=32))
TCFG = port_config(CFG)
KNOBS = ("BENCH_BATCH", "BENCH_STEPS", "BENCH_DTYPE", "BENCH_QUANT", "BENCH_STEM",
         "BENCH_PALLAS", "BENCH_TIMEOUT_S")
SMALL = {"BENCH_BATCH": "2", "BENCH_STEPS": "1"}
F32_ATOL = 1e-4  # tests/test_torch_models.py's float32 bar
COS_MIN = 0.999  # tests/test_torch_quant.py's bf16 / int8 bar
RECORD_KEYS = {"metric", "value", "unit", "vs_baseline"}


def _load(name, path):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


jbench = _load("root_bench", JAX_BENCH)
tbench = _load("port_bench", PORT_BENCH)

# the configurations: a config named with a knob keeps the others' defaults
# (the stem defaults to p8 only on the int8 rung, so c names it)
CONFIGS = {
    "a_int8_p8": {},
    "b_int8_f32stem": {"BENCH_STEM": "f32"},
    "c_bf16_p8": {"BENCH_QUANT": "0", "BENCH_STEM": "p8"},
    "d_bf16_p8_pallas": {"BENCH_QUANT": "0", "BENCH_STEM": "p8", "BENCH_PALLAS": "1"},
    "e_bf16_f32stem": {"BENCH_QUANT": "0"},
    "f_float32": {"BENCH_DTYPE": "float32"},
    "f_float32_pallas": {"BENCH_DTYPE": "float32", "BENCH_PALLAS": "1"},
}
# the port's wrappers each route calls, per layer of an embed call
ROUTES = {
    "a_int8_p8": ("attention_block_q", "mlp_block_q"),
    "b_int8_f32stem": ("attention_block_q", "mlp_block_q"),
    "c_bf16_p8": ("attention_block", "mlp_block"),
    "d_bf16_p8_pallas": ("attention_pallas",),
    "e_bf16_f32stem": ("attention_block", "mlp_block"),
    "f_float32": (),
    "f_float32_pallas": ("attention_pallas",),
}
WRAPPERS = ((tfb, "attention_block"), (tfb, "mlp_block"), (tfbq, "attention_block_q"),
            (tfbq, "mlp_block_q"), (tattention, "attention_pallas"))


def _set_env(monkeypatch, env):
    for k in KNOBS:
        monkeypatch.delenv(k, raising=False)
    for k, v in env.items():
        monkeypatch.setenv(k, v)


def _cos_rows(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return (a * b).sum(-1) / (np.linalg.norm(a, axis=-1) * np.linalg.norm(b, axis=-1))


def _check_record(rec):
    assert set(rec) == RECORD_KEYS, rec
    assert rec["metric"] == "clip_vit_b16_embed_throughput"
    assert rec["unit"] == "images/sec/chip"
    assert rec["value"] > 0
    # both are rounded from one rate: value to 0.1, vs_baseline to 0.001 of 1,000
    assert abs(rec["vs_baseline"] - rec["value"] / 1000) <= 5e-4 + 5e-5


@pytest.fixture(scope="module")
def pair():
    """(JAX params, port CLIP) with the same weights, every bias and
    LayerNorm non-trivial (tests/test_torch_quant.py's ``pair``)."""
    rng = np.random.default_rng(0)
    np_params = jax.tree.map(
        lambda a: (a + 0.05 * rng.normal(size=a.shape)).astype(np.float32),
        to_jax_tree(tclip.init_clip_params(TCFG, torch.Generator().manual_seed(0))))
    model = tclip.CLIP(TCFG)
    model.load_state_dict(params_from_jax(np_params, TCFG))
    return jax.tree.map(jnp.asarray, np_params), model.requires_grad_(False).eval()


def _run_jax_bench(monkeypatch, capsys, env, params=None):
    """The root bench.py's ``main()`` in-process under ``env`` on the tiny
    arch (on ``params`` when given): its record, and the (input, output) of
    every call of the embed function it jits."""
    from debias_vision_lang_tpu.core import cache, registry
    from debias_vision_lang_tpu.models import clip as jclip

    _set_env(monkeypatch, env)
    monkeypatch.setattr(registry, "resolve_arch", lambda name: CFG)
    monkeypatch.setattr(cache, "enable_compilation_cache", lambda *a, **k: None)
    if params is not None:
        monkeypatch.setattr(jclip, "init_clip_params", lambda key, cfg: params)
    calls, real_jit = [], jax.jit

    def recording_jit(fn, *args, **kwargs):
        jitted = real_jit(fn, *args, **kwargs)
        code = getattr(fn, "__code__", None)
        if code is None or code.co_filename != str(JAX_BENCH):
            return jitted

        def call(p, u8):
            out = jitted(p, u8)
            calls.append((np.asarray(u8), np.asarray(out)))
            return out

        return call

    monkeypatch.setattr(jax, "jit", recording_jit)
    jbench.main()
    monkeypatch.setattr(jax, "jit", real_jit)
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 1, lines
    return json.loads(lines[0]), calls


# ---------------------------------------------------------------------------
# Each configuration against the JAX function bench.py calls
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("config", list(CONFIGS))
def test_config_matches_the_jax_bench(config, pair, monkeypatch, capsys):
    jp, model = pair
    env = {**CONFIGS[config], **SMALL}
    rec, calls = _run_jax_bench(monkeypatch, capsys, env, params=jp)
    _check_record(rec)
    assert len(calls) == 3  # two warm-up calls and one timed step
    u8, want = calls[0]

    knobs = tbench.parse_knobs(env, on_card=True)  # the card's route
    embed, shape = tbench.make_embed(model, TCFG, knobs, "cpu")
    assert shape == u8.shape
    bufs = tbench.inputs(shape, "cpu")
    assert np.array_equal(bufs[0].numpy(), u8) and np.array_equal(bufs[1].numpy(), calls[1][0])

    counts = {}
    for mod, name in WRAPPERS:
        def spy(*a, _fn=getattr(mod, name), _name=name, **k):
            counts[_name] = counts.get(_name, 0) + 1
            return _fn(*a, **k)

        monkeypatch.setattr(mod, name, spy)
    got = embed(bufs[0])
    assert counts == {name: CFG.vision.layers for name in ROUTES[config]}
    assert got.dtype == torch.float32 and got.shape == (2, CFG.vision.embed_dim)
    if knobs.dtype == "float32":
        np.testing.assert_allclose(got.numpy(), want, atol=F32_ATOL, rtol=0)
    else:
        assert _cos_rows(got.numpy(), want).min() >= COS_MIN


# ---------------------------------------------------------------------------
# The knobs
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("env,on_card,want", [
    ({}, True, (True, True, "bfloat16", False)),
    ({"BENCH_STEM": "f32"}, True, (True, False, "bfloat16", False)),
    ({"BENCH_QUANT": "0"}, True, (False, False, "bfloat16", False)),
    ({"BENCH_QUANT": "0", "BENCH_STEM": "p8"}, True, (False, True, "bfloat16", False)),
    ({"BENCH_QUANT": "0", "BENCH_STEM": "p8", "BENCH_PALLAS": "1"}, True,
     (False, True, "bfloat16", True)),
    ({"BENCH_QUANT": "0", "BENCH_STEM": "p8", "BENCH_PALLAS": "1"}, False,
     (False, True, "bfloat16", False)),
    ({"BENCH_DTYPE": "float32"}, True, (False, False, "float32", False)),
    ({"BENCH_DTYPE": "float32", "BENCH_QUANT": "1"}, True, (False, False, "float32", False)),
    ({"BENCH_DTYPE": "float32", "BENCH_STEM": "p8"}, True, (False, False, "float32", False)),
    ({"BENCH_DTYPE": "float32", "BENCH_PALLAS": "1"}, True, (False, False, "float32", True)),
    ({"BENCH_DTYPE": "float32", "BENCH_PALLAS": "1"}, False,
     (False, False, "float32", False)),
    ({"BENCH_DTYPE": "bfloat16", "BENCH_STEM": "p8", "BENCH_QUANT": "1"}, False,
     (True, True, "bfloat16", False)),
])
def test_knobs_as_the_root_bench(env, on_card, want):
    k = tbench.parse_knobs(env, on_card)
    assert (k.quant, k.use_p8, k.dtype, k.use_pallas) == want


def test_knob_defaults():
    k = tbench.parse_knobs({}, on_card=True)
    assert (k.batch, k.steps, k.timeout_s) == (512, 20, 1800.0)
    k = tbench.parse_knobs({"BENCH_BATCH": "256", "BENCH_STEPS": "3",
                            "BENCH_TIMEOUT_S": "60"}, on_card=True)
    assert (k.batch, k.steps, k.timeout_s) == (256, 3, 60.0)


# ---------------------------------------------------------------------------
# The JSON line, the watchdog, the refusal, the CLI
# ---------------------------------------------------------------------------


def test_record_rounds_as_the_root_bench():
    ips = 9763.5481
    assert tbench.record(ips) == {"metric": "clip_vit_b16_embed_throughput",
                                  "value": round(ips, 1), "unit": "images/sec/chip",
                                  "vs_baseline": round(ips / 1000.0, 3)}
    assert tbench.A100_TORCH_BASELINE_IMG_S == jbench.A100_TORCH_BASELINE_IMG_S


@pytest.mark.parametrize("which", ["jax", "port"])
def test_json_line_contract(which, monkeypatch, capsys):
    if which == "jax":
        rec, _ = _run_jax_bench(monkeypatch, capsys, SMALL)
    else:
        from debias_vision_lang_torch.core import registry

        _set_env(monkeypatch, SMALL)
        monkeypatch.setattr(registry, "resolve_arch", lambda name: TCFG)
        assert tbench.main(["--device", "cpu"]) == 0
        lines = capsys.readouterr().out.strip().splitlines()
        assert len(lines) == 1, lines
        rec = json.loads(lines[0])
    _check_record(rec)


_STALLED = """
import importlib.util, sys, time
spec = importlib.util.spec_from_file_location("port_bench", sys.argv[1])
bench = importlib.util.module_from_spec(spec)
spec.loader.exec_module(bench)
bench.build_model = lambda cfg, device: time.sleep(120)  # a device that hangs
sys.exit(bench.main(["--device", "cpu"]))
"""


def test_watchdog_prints_the_error_record_and_exits_2():
    env = {k: v for k, v in os.environ.items() if k not in KNOBS}
    proc = subprocess.run([sys.executable, "-c", _STALLED, str(PORT_BENCH)], cwd=REPO,
                          env={**env, "BENCH_TIMEOUT_S": "2"}, capture_output=True,
                          text=True, timeout=100)
    assert proc.returncode == 2, proc.stderr[-2000:]
    lines = proc.stdout.strip().splitlines()
    assert len(lines) == 1, proc.stdout
    rec = json.loads(lines[0])
    assert set(rec) == RECORD_KEYS | {"error"}
    assert rec["value"] == 0.0 and rec["vs_baseline"] == 0.0
    assert "timed out after 2s" in rec["error"]
    assert "tunnel" not in rec["error"]


@pytest.mark.skipif(torch.cuda.is_available(), reason="needs a machine with no card")
def test_no_card_exits_2_and_runs_nothing(monkeypatch, capsys):
    def refuse(*a, **k):
        raise AssertionError("the bench built a model without a card")

    _set_env(monkeypatch, SMALL)
    monkeypatch.setattr(tbench, "build_model", refuse)
    assert tbench.main([]) == 2
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 1
    rec = json.loads(lines[0])
    assert set(rec) == RECORD_KEYS | {"error"} and rec["value"] == 0.0
    assert "no CUDA device" in rec["error"] and "--device cpu" in rec["error"]


def test_cli_bench_runs_the_port_bench(monkeypatch, capsys):
    """``tcli.main(["bench", "--device", "cpu"])`` runs the script as
    ``__main__``: one JSON line, exit 0."""
    from debias_vision_lang_torch.core import registry

    _set_env(monkeypatch, SMALL)
    monkeypatch.setattr(registry, "resolve_arch", lambda name: TCFG)
    with pytest.raises(SystemExit) as exc:
        tcli.main(["bench", "--device", "cpu"])
    assert exc.value.code == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 1, lines
    _check_record(json.loads(lines[0]))


# ---------------------------------------------------------------------------
# utils/observability.py
# ---------------------------------------------------------------------------


def test_utils_exports_the_jax_names():
    import debias_vision_lang_torch.utils as tutils
    import debias_vision_lang_tpu.utils as jutils

    names = {"MetricsLogger", "profile_trace", "step_timer", "enable_debug_nans"}
    assert names <= set(vars(jutils))
    for name in names:
        assert callable(getattr(tutils, name))


def test_step_timer_logs_step_time(tmp_path):
    from debias_vision_lang_torch.utils import MetricsLogger, step_timer

    logger = MetricsLogger(str(tmp_path))
    with step_timer(logger, step=1) as box:
        pass
    with step_timer(logger, name="embed_s", step=2) as box2:
        pass
    logger.close()
    assert box["elapsed"] >= 0 and box2["elapsed"] >= 0
    rows = [json.loads(line) for line in open(logger.path)]
    assert rows[0]["step_time_s"] == box["elapsed"] and rows[0]["step"] == 1
    assert rows[1]["embed_s"] == box2["elapsed"] and rows[1]["step"] == 2
    with step_timer() as box3:  # no logger: the box only
        pass
    assert box3["elapsed"] >= 0


@pytest.mark.parametrize("enabled", [True, False])
def test_profile_trace(tmp_path, enabled):
    from debias_vision_lang_torch.utils import profile_trace

    log_dir = tmp_path / "trace"
    with profile_trace(str(log_dir), enabled=enabled) as prof:
        torch.ones(64, 64).matmul(torch.ones(64, 64)).sum()
    if not enabled:
        assert prof is None and not log_dir.exists()
        return
    traces = list(log_dir.glob("*.pt.trace.json"))
    assert len(traces) == 1
    events = json.loads(traces[0].read_text())["traceEvents"]
    assert any("matmul" in e.get("name", "") for e in events)


def test_enable_debug_nans_toggles_anomaly_mode():
    from debias_vision_lang_torch.utils import enable_debug_nans

    was = (torch.is_anomaly_enabled(), torch.is_anomaly_check_nan_enabled())
    try:
        enable_debug_nans()
        assert torch.is_anomaly_enabled() and torch.is_anomaly_check_nan_enabled()
        # a NaN made in the backward only: sqrt'(0) = inf times the zero
        # gradient of * 0, every forward value finite
        x = torch.tensor([0.0], requires_grad=True)
        with pytest.raises(RuntimeError, match="nan"):
            (torch.sqrt(x) * 0).sum().backward()
        enable_debug_nans(False)
        assert not torch.is_anomaly_enabled()
        (torch.sqrt(x) * 0).sum().backward()  # no check: the NaN gradient passes
        assert torch.isnan(x.grad).all()
    finally:
        enable_debug_nans(False)
        torch.autograd.set_detect_anomaly(was[0], check_nan=was[1])


def _debug_nans_block():
    """A bf16 MLP block's tensors at width 64 and an input whose one inf
    makes LayerNorm's mean inf, and its output NaN, in the forward."""
    g = torch.Generator().manual_seed(0)
    d = 64
    args = (torch.ones(d), torch.zeros(d), torch.randn(d, 4 * d, generator=g) * 0.1,
            torch.zeros(4 * d), torch.randn(4 * d, d, generator=g) * 0.1, torch.zeros(d))
    x = torch.randn(1, 5, d, generator=g).to(torch.bfloat16)
    x[0, 2, 7] = float("inf")
    return x, args


@pytest.mark.parametrize("on", [True, False])
def test_enable_debug_nans_raises_at_an_inference_nan(on):
    """As jax_debug_nans: with the helper on, the forward op that makes a
    NaN raises FloatingPointError, with no backward (under no_grad, the
    fused MLP entry on the CPU); off, the NaN flows out and nothing is
    installed."""
    from debias_vision_lang_torch.ops import fused_block as fb
    from debias_vision_lang_torch.utils import enable_debug_nans
    from debias_vision_lang_torch.utils.observability import debug_nans_on

    was = (torch.is_anomaly_enabled(), torch.is_anomaly_check_nan_enabled())
    depth = torch._C._len_torch_function_stack()
    x, args = _debug_nans_block()
    try:
        enable_debug_nans(on)
        assert debug_nans_on() is on
        assert torch._C._len_torch_function_stack() == depth + int(on)
        with torch.no_grad():
            if on:
                with pytest.raises(FloatingPointError, match="NaN in the output of"):
                    fb.mlp_block(x, *args)
            else:
                assert torch.isnan(fb.mlp_block(x, *args)).any()
            assert not torch.isnan(fb.mlp_block(torch.zeros_like(x), *args)).any()
    finally:
        enable_debug_nans(False)
        torch.autograd.set_detect_anomaly(was[0], check_nan=was[1])
    assert torch._C._len_torch_function_stack() == depth and not debug_nans_on()


@pytest.mark.parametrize("on", [True, False])
def test_kernel_entries_check_their_outputs_when_on(on):
    """A CUDA kernel entry's ctypes launch is no torch function: the
    entries call ``check_nans`` on their outputs, which raises only when
    the helper is on."""
    from debias_vision_lang_torch.utils import enable_debug_nans
    from debias_vision_lang_torch.utils.observability import check_nans

    was = (torch.is_anomaly_enabled(), torch.is_anomaly_check_nan_enabled())
    bad = torch.tensor([1.0, float("nan")])
    try:
        enable_debug_nans(on)
        check_nans("dvl_mlp_block", torch.ones(3), torch.arange(3))
        if on:
            with pytest.raises(FloatingPointError, match="dvl_mlp_block"):
                check_nans("dvl_mlp_block", torch.ones(3), bad)
        else:
            check_nans("dvl_mlp_block", bad)
    finally:
        enable_debug_nans(False)
        torch.autograd.set_detect_anomaly(was[0], check_nan=was[1])
