"""The README's six examples on the port (``examples_torch/``), on the
CPU at small sizes: each ``main`` runs with ``--device cpu`` and its own
assertion holds; fused_mastering's graph, unfused and fused, against
examples/fused_mastering.py's through grafx_tpu on the same numpy input
and parameters; match_mix's and neural_mixing's target render, first
loss and first gradient against their JAX examples' on the same numpy
stems, parameters and weights; the served WAV against a live
StreamRenderer, bit for bit; the streamed console against its one-shot render; the two-rank
data-parallel check over gloo.  No example imports jax, grafx_tpu or
bench.py."""

import ast
import importlib.util
import os

import jax
import numpy as np
import pytest
import torch

from examples_torch import (
    fused_mastering,
    match_mix,
    multihost_dp,
    neural_mixing,
    serve_stream_wav,
    streaming_console,
)
from grafx_tpu_torch.checkpoint import load_session
from grafx_tpu_torch.models import GraphParameterOptimizer
from grafx_tpu_torch.render import StreamRenderer
from grafx_tpu_torch.utils import parameters_from_numpy, tree_items, tree_map

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EXAMPLES = ("fused_mastering", "match_mix", "multihost_dp", "neural_mixing",
            "serve_stream_wav", "streaming_console")
MODULES = dict(zip(EXAMPLES, (fused_mastering, match_mix, multihost_dp, neural_mixing,
                              serve_stream_wav, streaming_console)))
# rel. to max|ref|: the port's render against grafx_tpu's for the same
# filter classes (tests/test_torch_filters.py)
REL = 1e-5
# a streamed render against the one-shot render (tests/test_torch_rng_render.py)
STREAM_REL = 1e-5
FUSED_CHAINS, FUSED_LEN = 3, 2**12
# a first step's loss and gradient against jax.value_and_grad's, as
# tests/test_torch_models.py holds the console's: the loss and the
# concatenated gradient within LOSS_DB / GRAD_DB, each leaf whose JAX
# gradient is nonzero within LEAF_DB, a zero JAX leaf zero
LOSS_DB, GRAD_DB, LEAF_DB = -60.0, -60.0, -40.0
FLOAT32_SPREAD = 2.0  # see assert_render
# match_mix: 2 tracks of 1024 samples, whose MR-STFT loss reflects past
# the signal (a 2048-point FFT pads 1024 on each side)
MIX_TRACKS, MIX_SECONDS = 2, 0.02
NEURAL_TRACKS, NEURAL_SECONDS = 2, 0.05  # neural_mixing: 2 tracks of 2205 samples
STREAM_CHAINS, STREAM_LEN = 3, 2**14


@pytest.fixture(autouse=True)
def one_thread():
    """The examples run many small ops: one intra-op thread each keeps
    them from spinning against the other test processes' threads."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def imported_modules(path):
    with open(path) as f:
        tree = ast.parse(f.read())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names.update(a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            names.add(node.module)
    return names


@pytest.mark.parametrize("name", EXAMPLES + ("_common", "__init__"))
def test_example_imports_neither_jax_nor_grafx_tpu(name):
    path = os.path.join(ROOT, "examples_torch", f"{name}.py")
    assert os.path.isfile(os.path.join(ROOT, "examples", f"{name}.py")) or name.startswith("_")
    for module in imported_modules(path):
        top = module.split(".")[0]
        assert top not in ("jax", "jaxlib", "grafx_tpu", "bench", "optax"), (name, module)


@pytest.mark.parametrize("name", EXAMPLES)
def test_example_defaults_to_the_card_and_raises_without_one(name):
    if torch.cuda.is_available():
        pytest.skip("torch sees a card, so the default device runs")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        MODULES[name].main([])


# ---------------------------------------------------------------------------
# fused_mastering
# ---------------------------------------------------------------------------


def test_fused_mastering_runs():
    out = fused_mastering.main(["--device", "cpu", "--audio-len", "2048", "--batch", "1"])
    assert out["fused_types"] == ["fused(ls+pk+hs+lp)"]
    assert out["rel"] < fused_mastering.REL and out["nodes"] == 104 and out["fused_nodes"] == 53


def node_types(G):
    return [(n, d["node_type"]) for n, d in G.nodes(data=True)]


def jax_example(name):
    """examples/<name>.py, the JAX example, as a module (its main not
    run)."""
    spec = importlib.util.spec_from_file_location(
        f"jax_{name}", os.path.join(ROOT, "examples", f"{name}.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.fixture(scope="module")
def jax_fused_mastering():
    return jax_example("fused_mastering")


def db(err, ref):
    with np.errstate(divide="ignore"):  # -inf where the two are equal
        return 20 * np.log10(np.linalg.norm(err) / np.linalg.norm(ref))


def max_rel(got, ref):
    return np.abs(got - ref).max() / np.abs(ref).max()


def assert_first_step(loss, loss_j, grads, grads_j):
    """Hold a first step (``{leaf path: numpy gradient}`` each) against
    grafx_tpu's at LOSS_DB, GRAD_DB and LEAF_DB."""
    assert db(np.float64(loss) - np.float64(loss_j), np.float64(loss_j)) <= LOSS_DB, (loss, loss_j)
    assert grads.keys() == grads_j.keys()
    cat = lambda g: np.concatenate([g[k].ravel() for k in sorted(g)])  # noqa: E731
    assert db(cat(grads) - cat(grads_j), cat(grads_j)) <= GRAD_DB
    for k, ref in grads_j.items():
        if np.any(ref != 0):
            assert db(grads[k] - ref, ref) <= LEAF_DB, (k, db(grads[k] - ref, ref))
        else:
            assert np.all(grads[k] == 0), k


@pytest.mark.parametrize("fused", [False, True], ids=["unfused", "fused"])
def test_fused_mastering_renders_match_grafx_tpu(jax_fused_mastering, fused, monkeypatch):
    """The port's build() graph against examples/fused_mastering.py's
    build() through grafx_tpu, on the same input and parameters (drawn by
    grafx_tpu, carried across by parameters_from_numpy)."""
    import jax.numpy as jnp

    from grafx_tpu.render import fuse_serial_lti as j_fuse
    from grafx_tpu.utils import create_empty_parameters as j_params

    from grafx_tpu_torch.render import fuse_serial_lti, make_render_fn

    monkeypatch.setattr(jax_fused_mastering, "NUM_CHAINS", FUSED_CHAINS)
    monkeypatch.setattr(fused_mastering, "NUM_CHAINS", FUSED_CHAINS)
    jG, jprocs = jax_fused_mastering.build()
    tG, tprocs = fused_mastering.build()
    assert node_types(jG) == node_types(tG)
    x = np.random.default_rng(0).standard_normal((1, FUSED_CHAINS, 2, FUSED_LEN)).astype(np.float32)
    params = jax.tree.map(lambda v: np.asarray(v) + np.float32(0.1),
                          j_params(jprocs, jG, key=jax.random.PRNGKey(0)))
    if fused:
        jG, jprocs = j_fuse(jG, jprocs)
        tG, tprocs = fuse_serial_lti(tG, tprocs)
        params = fused_mastering.fused_parameters(params, tprocs)
    jrender = jax_fused_mastering.prepare(jG, jprocs, FUSED_LEN, 1)[0]
    ref = np.asarray(jrender(jnp.asarray(x), jax.tree.map(jnp.asarray, params))[0])
    tplan = fused_mastering.prepare(tG, tprocs, torch.device("cpu"))
    with torch.no_grad():
        got = make_render_fn(tprocs, tplan)(torch.tensor(x), parameters_from_numpy(params))[0]
    err = np.abs(got.numpy() - ref).max() / np.abs(ref).max()
    assert got.shape == ref.shape
    assert err <= REL, err


# ---------------------------------------------------------------------------
# streaming_console, serve_stream_wav
# ---------------------------------------------------------------------------


def test_streaming_console_streams_its_one_shot_render(monkeypatch):
    monkeypatch.setattr(streaming_console, "NUM_CHAINS", STREAM_CHAINS)
    monkeypatch.setattr(streaming_console, "AUDIO_LEN", STREAM_LEN)
    out = streaming_console.main(["1024", "--device", "cpu"])
    assert out["blocks"] == 16 and out["compressor_stages"] >= 2
    assert out["err_rel"] <= STREAM_REL, out["err_rel"]
    assert sorted(out["step_many"]) == [4, 16]
    for k, entry in out["step_many"].items():
        assert entry["err_rel"] <= STREAM_REL, (k, entry["err_rel"])


@pytest.mark.parametrize("source", ["synthetic", "wav"])
def test_serve_stream_wav_serves_the_live_stream(source, tmp_path):
    """The loaded artifact's blocks equal a live StreamRenderer's bit for
    bit; the written WAV reads back as the output in 16-bit PCM; a WAV
    input reads as the program it holds."""
    from scipy.io import wavfile

    sr, audio = serve_stream_wav.load_input(None)
    in_path = ""
    if source == "wav":
        in_path = str(tmp_path / "in.wav")
        wavfile.write(in_path, sr, (audio.T * 32767).astype(np.int16))
        sr, audio = serve_stream_wav.load_input(in_path)
        assert audio.shape == (2, 4 * serve_stream_wav.SR)
    out_path = str(tmp_path / "out" / "served.wav")
    out = serve_stream_wav.main([in_path, out_path, "4096", "--device", "cpu"])
    assert out["blocks"] == audio.shape[-1] // 4096 and out["artifact_mb"] > 0

    procs, plan, params = serve_stream_wav.build(torch.device("cpu"))
    streamer = StreamRenderer(procs, plan, params, block_len=4096)
    state, live = streamer.init_state(), []
    x = torch.from_numpy(np.ascontiguousarray(audio[:, : out["blocks"] * 4096]))
    for xb in x.split(4096, dim=-1):
        y, state = streamer(xb[None], state)
        live.append(y[0])
    live = torch.cat(live, dim=-1).numpy()
    assert np.array_equal(out["output"], live)

    sr_back, pcm = wavfile.read(out_path)
    assert sr_back == sr and np.array_equal(pcm, serve_stream_wav.to_int16(live))


# ---------------------------------------------------------------------------
# match_mix, neural_mixing, multihost_dp
# ---------------------------------------------------------------------------


def test_match_mix_fits_and_saves(tmp_path):
    out = match_mix.main(["--device", "cpu", "--steps", "3", "--tracks", "2",
                          "--seconds", "0.05", "--save", str(tmp_path / "session")])
    assert out["length"] == 4096 and out["loss_last"] < out["loss_first"]
    G, params, metadata = load_session(str(tmp_path / "session"))
    assert metadata == {"steps": 3} and G.number_of_nodes() == out["nodes"]
    assert set(params) == {"eq", "compressor", "gain", "geq", "reverb"}


def float64(tree):
    return jax.tree.map(lambda v: np.asarray(v, np.float64), tree)


def assert_render(got32, got64, ref32, ref64):
    """A render of both packages from the same numpy inputs, in float64
    (the port's processors and inputs in double, grafx_tpu's under
    jax.enable_x64) and in float32: in float64 the port within REL of
    max|ref|; in float32 the port no further from the float64 render
    than FLOAT32_SPREAD x grafx_tpu's own float32 render is.  (The
    consoles' graphic equalizer puts the float32 renders 3e-5 to 3e-4
    of max|ref| off their float64 ones at these parameters, while the
    float64 renders agree to 3e-8: a float32 comparison of the two
    packages holds rounding, not their math.)"""
    assert got32.shape == ref32.shape == got64.shape == ref64.shape
    assert max_rel(got64, ref64) <= REL, max_rel(got64, ref64)
    assert max_rel(got32, ref64) <= FLOAT32_SPREAD * max_rel(ref32, ref64), (
        max_rel(got32, ref64), max_rel(ref32, ref64))


def test_match_mix_matches_grafx_tpu():
    """examples/match_mix.py's console, stems and ground truth through
    grafx_tpu, and the port's console on the same numpy stems and
    parameters: the target render (assert_render), then the fit's first
    MR-STFT loss and gradient from grafx_tpu's seed-1 start against
    jax.value_and_grad's, both in float64 (assert_first_step)."""

    from grafx_tpu.models import GraphParameterOptimizer as JOptimizer
    from grafx_tpu.models import mixing_console as j_mixing_console
    from grafx_tpu.ops.losses import multi_resolution_stft_loss as j_mrstft

    jm = jax_example("match_mix")
    length = match_mix.signal_length(MIX_SECONDS)
    G_j, procs_j = j_mixing_console(num_tracks=MIX_TRACKS, track_chain=("eq", "compressor", "gain"),
                                    bus_chain=("geq",), reverb_send=True, ir_len=8000)
    G, procs = match_mix.console(MIX_TRACKS)
    assert list(G.nodes(data=True)) == list(G_j.nodes(data=True))
    assert list(G.edges(data=True)) == list(G_j.edges(data=True))
    assert list(procs) == list(procs_j)

    # the JAX example's draws, in float32
    stems = np.asarray(jm.synthetic_stems(MIX_TRACKS, length, jax.random.PRNGKey(0)))
    opt_gt_j = JOptimizer(G_j, procs_j, key=jax.random.PRNGKey(7))
    truth = jax.tree.map(
        lambda p: np.asarray(p + 0.3 * jax.random.normal(jax.random.PRNGKey(8), p.shape)), opt_gt_j.params)
    start = jax.tree.map(np.asarray, JOptimizer(G_j, procs_j, key=jax.random.PRNGKey(1)).params)
    render_j = jax.jit(opt_gt_j.render)
    ref32 = np.asarray(render_j(stems, truth)[0])
    opt_gt = GraphParameterOptimizer(G, procs, device="cpu")
    with torch.no_grad():
        tree_map(lambda p, v: p.copy_(v), opt_gt.params, parameters_from_numpy(truth))
        got32 = opt_gt.render_current(torch.tensor(stems)).numpy()

    with jax.enable_x64(True):
        ref64 = np.asarray(render_j(stems.astype(np.float64), float64(truth))[0])
        loss_j, grads_j = jax.jit(jax.value_and_grad(
            lambda p: j_mrstft(opt_gt_j.render(stems.astype(np.float64), p)[0], ref64)))(float64(start))
    for proc in procs.values():
        proc.double()
    opt = GraphParameterOptimizer(G, procs, device="cpu", jit=False)
    with torch.no_grad():
        opt.params = tree_map(lambda v: v.double(), parameters_from_numpy(truth))
        got64 = opt.render_current(torch.tensor(stems).double()).numpy()
        opt.params = tree_map(lambda v: v.double().requires_grad_(True), parameters_from_numpy(start))
    assert_render(got32, got64, ref32, ref64)

    total, audio = opt.loss(torch.tensor(stems).double(), torch.tensor(ref64))
    assert total.item() == audio.item()  # no auxiliary loss in this console
    total.backward()
    assert_first_step(audio.item(), float(loss_j),
                      {k: p.grad.numpy() for k, p in tree_items(opt.params)},
                      dict(tree_items(jax.tree.map(np.asarray, grads_j))))


def test_neural_mixing_matches_grafx_tpu():
    """examples/neural_mixing.py's stems, ground truth and predictor
    weights through grafx_tpu, and the port's console, conditioning and
    loss on the same numpy stems, parameters and weights: the target
    render (assert_render), then the first MR-STFT loss and its gradient
    in the predictor's weights against jax.value_and_grad's, both in
    float64 (assert_first_step)."""
    import jax.numpy as jnp

    from grafx_tpu.data import convert_to_tensor as j_convert
    from grafx_tpu.models import mixing_console as j_mixing_console
    from grafx_tpu.models.predictor import ParameterPredictor as JPredictor
    from grafx_tpu.models.predictor import audio_features as j_audio_features
    from grafx_tpu.ops.losses import multi_resolution_stft_loss as j_mrstft
    from grafx_tpu.render import make_render_fn as j_make_render_fn
    from grafx_tpu.render import prepare_render as j_prepare
    from grafx_tpu.render import reorder_for_fast_render as j_reorder
    from grafx_tpu.utils import count_nodes_per_type as j_count
    from grafx_tpu.utils import create_empty_parameters as j_params

    from grafx_tpu_torch.ops.losses import precompute_stft_targets
    from grafx_tpu_torch.render import make_render_fn

    jm = jax_example("neural_mixing")
    length = int(NEURAL_SECONDS * neural_mixing.SR)
    G_j, procs_j = j_mixing_console(num_tracks=NEURAL_TRACKS)
    render_j = j_make_render_fn(procs_j, j_prepare(j_reorder(j_convert(G_j), method="beam")), jit=False)
    G, procs, plan = neural_mixing.console(NEURAL_TRACKS, torch.device("cpu"))
    assert list(G.nodes(data=True)) == list(G_j.nodes(data=True))
    render = make_render_fn(procs, plan, jit=False)

    # the JAX example's draws, in float32
    stems = np.asarray(jm.synthetic_stems(NEURAL_TRACKS, length, jax.random.PRNGKey(0)))
    truth = jax.tree.map(np.asarray, j_params(procs_j, G_j, key=jax.random.PRNGKey(7), std=0.5))
    mean_feat = j_audio_features(jnp.asarray(stems), num_bands=32).mean(axis=0)
    predictor_j = JPredictor(procs_j, feature_dim=mean_feat.shape[0])
    weights = jax.tree.map(np.asarray, predictor_j.init(jax.random.PRNGKey(1)))
    ref32 = np.asarray(jax.jit(render_j)(stems, truth)[0])
    with torch.no_grad():
        got32 = render(torch.tensor(stems), parameters_from_numpy(truth))[0].numpy()

    with jax.enable_x64(True):
        stems64 = stems.astype(np.float64)
        ref64 = np.asarray(jax.jit(render_j)(stems64, float64(truth))[0])
        mean_feat = j_audio_features(jnp.asarray(stems64), num_bands=32).mean(axis=0)
        per_type_j = {t: jnp.broadcast_to(mean_feat[None], (n, mean_feat.shape[0]))
                      for t, n in j_count(G_j).items() if t in procs_j and n > 0}
        loss_j, grads_j = jax.jit(jax.value_and_grad(
            lambda w: j_mrstft(render_j(stems64, predictor_j.apply(w, per_type_j))[0], ref64)))(
                float64(weights))
    for proc in procs.values():
        proc.double()
    with torch.no_grad():
        got64 = render(torch.tensor(stems64), tree_map(lambda v: v.double(),
                                                       parameters_from_numpy(truth)))[0].numpy()
    assert_render(got32, got64, ref32, ref64)

    predictor, per_type = neural_mixing.conditioning(G, procs, torch.tensor(stems64),
                                                     torch.Generator().manual_seed(1))
    assert per_type.keys() == per_type_j.keys()
    predictor.double()
    with torch.no_grad():
        predictor.load_numpy(weights)
    loss = neural_mixing.loss_of(predictor, per_type, render, torch.tensor(stems64),
                                 precompute_stft_targets(torch.tensor(ref64)))
    loss.backward()
    grads = {}
    for t, mlp in predictor.mlps.items():
        for layer, wk, bk in ((mlp[0], "w1", "b1"), (mlp[2], "w2", "b2")):
            grads[f"{t}/{wk}"] = layer.weight.grad.T.numpy()
            grads[f"{t}/{bk}"] = layer.bias.grad.numpy()
    assert_first_step(loss.item(), float(loss_j), grads,
                      {f"{t}/{k}": np.asarray(v) for t, w in grads_j.items() for k, v in w.items()})


def test_neural_mixing_trains():
    out = neural_mixing.main(["--device", "cpu", "--steps", "3", "--tracks", "2",
                              "--seconds", "0.1"])
    assert out["length"] == 4410 and out["loss_last"] < out["loss_first"]
    assert out["compressor_stages"] == 2


def test_multihost_dp_two_gloo_ranks_match_one_process():
    out = multihost_dp.main(["--device", "cpu"])
    assert out["rel"] < multihost_dp.TOL and out["p_err"] < multihost_dp.TOL
    assert [r["rank"] for r in out["ranks"]] == [0, 1]
    for r in out["ranks"]:
        assert r["local_shape"] == [multihost_dp.GLOBAL_BATCH // 2, 4, 2, multihost_dp.L]
