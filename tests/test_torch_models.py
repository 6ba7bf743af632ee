"""The model builders, the console's first fit step and the neural
parameter predictor of grafx_tpu_torch against grafx_tpu on the same
numpy inputs and parameters (3 tracks, L = 2^12, reverb ir_len 2000),
and the predictor trained through the render."""

import inspect

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from grafx_tpu.data import convert_to_tensor as j_convert
from grafx_tpu.models import console as jconsole
from grafx_tpu.models.predictor import ParameterPredictor as JPredictor
from grafx_tpu.models.predictor import audio_features as j_audio_features
from grafx_tpu.ops.losses import multi_resolution_stft_loss as j_mrstft
from grafx_tpu.processors.core.utils import rms_difference as j_rms_difference
from grafx_tpu.render import make_render_fn as j_make_render_fn
from grafx_tpu.render import prepare_render as j_prepare
from grafx_tpu.render import reorder_for_fast_render as j_reorder
from grafx_tpu.utils import create_empty_parameters as j_create_params
from grafx_tpu.utils import get_node_ids_from_type as j_node_ids
from grafx_tpu_torch.data import GRAFX, NodeConfigs, convert_to_tensor
from grafx_tpu_torch.models import (
    GraphParameterOptimizer,
    ParameterPredictor,
    audio_features,
    console,
    mixing_console,
)
from grafx_tpu_torch.models.predictor import features_per_type
from grafx_tpu_torch.ops.losses import multi_resolution_stft_loss
from grafx_tpu_torch.processors import StereoGain, TanhDistortion
from grafx_tpu_torch.processors.core.utils import accepts_noise_key, rms_difference
from grafx_tpu_torch.render import make_render_fn, prepare_render, reorder_for_fast_render
from grafx_tpu_torch.utils import get_node_ids_from_type, parameters_from_numpy, tree_items, tree_map

TRACKS, L, IR_LEN = 3, 2**12, 2000
BUILDERS = {
    "simple_chain": ("simple_chain", {}),
    "simple_chain_gain": ("simple_chain", {"chain": ("gain",)}),
    "mixing_console": ("mixing_console", {"num_tracks": TRACKS, "ir_len": IR_LEN}),
    "mixing_console_delay": ("mixing_console", {
        "num_tracks": TRACKS, "ir_len": IR_LEN, "track_chain": ("eq", "compressor", "gain", "delay"),
        "bus_chain": ("geq",), "reverb_send": False,
    }),
    "mastering_chain": ("mastering_chain", {}),
}


def db(err, ref):
    with np.errstate(divide="ignore"):  # -inf where the two are equal
        return 20 * np.log10(np.linalg.norm(err) / np.linalg.norm(ref))


def max_rel(got, ref):
    return np.abs(got - ref).max() / np.abs(ref).max()


def build(package, name):
    builder, kwargs = BUILDERS[name]
    return getattr(package, builder)(**kwargs)


@pytest.mark.parametrize("name", list(BUILDERS))
def test_builders_match_grafx_tpu(name):
    """The same node types, edges (with their outlets and inlets) and
    processors (class and parameter sizes) as grafx_tpu's builder."""
    (G, procs), (G_j, procs_j) = build(console, name), build(jconsole, name)
    assert list(G.nodes(data=True)) == list(G_j.nodes(data=True))
    assert list(G.edges(data=True)) == list(G_j.edges(data=True))
    assert G.config.node_type_dict == G_j.config.node_type_dict
    assert list(procs) == list(procs_j)
    for t in procs:
        assert type(procs[t]).__name__ == type(procs_j[t]).__name__, t
        assert procs[t].parameter_size() == procs_j[t].parameter_size(), t
    for t in G.config.node_types:
        assert get_node_ids_from_type(G, t) == j_node_ids(G_j, t)
    if name == "mixing_console":
        assert G.number_of_nodes() == 4 * TRACKS + 6


def test_default_processors_match_grafx_tpu():
    ours, theirs = console._default_processors(), jconsole._default_processors()
    assert list(ours) == list(theirs)
    for t in ours:
        assert type(ours[t]).__name__ == type(theirs[t]).__name__, t
        assert ours[t].parameter_size() == theirs[t].parameter_size(), t
    assert console.mixing_console(num_tracks=16)[0].number_of_nodes() == 70


def j_render(G_j, procs_j, jit=True):
    """grafx_tpu's render of the graph (jitted by default: op by op the
    console's forward takes the CPU ~40 s)."""
    return j_make_render_fn(procs_j, j_prepare(j_reorder(j_convert(G_j), method="beam")), jit=jit)


def test_features_follow_the_parameter_rows():
    """features_per_type gives gain row r its track's stem (one-hot stem
    features name it) and the bus its mix's; silencing gain row r
    silences that stem, as zeroing its input does."""
    G, procs = mixing_console(num_tracks=TRACKS, ir_len=IR_LEN, reverb_send=False)
    per_type = features_per_type(G, procs, torch.eye(TRACKS), torch.full((TRACKS,), -1.0))
    stem_of_row = per_type["gain"].argmax(-1).tolist()
    assert sorted(stem_of_row) == list(range(TRACKS))
    assert torch.equal(per_type["geq"], torch.full((1, TRACKS), -1.0))
    assert per_type["compressor"].shape == (TRACKS + 1, TRACKS)
    plan = prepare_render(reorder_for_fast_render(convert_to_tensor(G), method="beam"))
    render = make_render_fn(procs, plan, jit=False)
    params = parameters_from_numpy(jax.tree.map(
        np.asarray, j_create_params(procs, G, key=jax.random.PRNGKey(2))))
    x = torch.tensor(np.random.default_rng(3).standard_normal((TRACKS, 2, L)).astype(np.float32))
    for r, stem in enumerate(stem_of_row):
        silenced = tree_map(lambda p: p.clone(), params)
        silenced["gain"]["log_gain"][r] = -60.0
        x0 = x.clone()
        x0[stem] = 0
        with torch.no_grad():
            got, ref = render(x, silenced)[0], render(x0, params)[0]
        assert max_rel(got.numpy(), ref.numpy()) <= 1e-5, r


def console_case(seed=0):
    """The 3-track console, a ground-truth parameter set (grafx_tpu's
    init plus 0.3 N(0, 1), as examples/match_mix.py draws one) rendered
    by grafx_tpu into the target, a start (grafx_tpu's init plus 0.1
    N(0, 1)), and the stems."""
    G_j, procs_j = jconsole.mixing_console(num_tracks=TRACKS, ir_len=IR_LEN)
    rng = np.random.default_rng(seed)
    init = jax.tree.map(np.asarray, j_create_params(procs_j, G_j, key=jax.random.PRNGKey(seed)))
    truth = jax.tree.map(lambda p: (p + 0.3 * rng.standard_normal(p.shape)).astype(np.float32), init)
    start = jax.tree.map(lambda p: (p + 0.1 * rng.standard_normal(p.shape)).astype(np.float32), init)
    x = (0.3 * rng.standard_normal((TRACKS, 2, L))).astype(np.float32)
    target = np.asarray(j_render(G_j, procs_j)(x, truth)[0])
    return G_j, procs_j, start, x, target


def test_mixing_console_first_step_matches_grafx_tpu():
    """The first fit step of mixing_console (MR-STFT, SGD lr 1e-2) from
    the same numpy parameters: the audio loss and the concatenated
    gradient within -60 dB of jax.value_and_grad's, each leaf whose JAX
    gradient is nonzero within -40 dB; the parameters after the step
    within -60 dB of start - lr * grad.

    The reference is jax.value_and_grad run op by op, as the port runs
    (and as tests/test_torch_train.py takes it): jitted, XLA's fusions
    round the gradient otherwise, and the MR-STFT loss's L1 term turns
    rounding into sign flips (PERF.md).  That takes this test ~2 minutes."""
    G_j, procs_j, start, x, target = console_case()
    render_j = j_render(G_j, procs_j, jit=False)

    def loss_j(p):
        return j_mrstft(render_j(x, p)[0], target)

    value_j, grads_j = jax.value_and_grad(loss_j)(start)
    G, procs = mixing_console(num_tracks=TRACKS, ir_len=IR_LEN)
    lr = 1e-2
    opt = GraphParameterOptimizer(G, procs, optimizer=lambda ps: torch.optim.SGD(ps, lr=lr),
                                  device="cpu")
    with torch.no_grad():
        tree_map(lambda p, v: p.copy_(v), opt.params, parameters_from_numpy(start))
    total, audio = opt.step(torch.tensor(x), torch.tensor(target))
    assert total.item() == audio.item()  # no aux loss in this console
    assert db(np.float64(audio.item()) - float(value_j), np.float64(value_j)) <= -60.0
    got = {k: p.grad.numpy() for k, p in tree_items(opt.params)}
    ref = dict(tree_items(jax.tree.map(np.asarray, grads_j)))
    assert got.keys() == ref.keys()
    cat = lambda g: np.concatenate([g[k].ravel() for k in sorted(g)])  # noqa: E731
    assert db(cat(got) - cat(ref), cat(ref)) <= -60.0
    for k in ref:
        if np.any(ref[k] != 0):
            assert db(got[k] - ref[k], ref[k]) <= -40.0, (k, db(got[k] - ref[k], ref[k]))
        else:
            assert np.all(got[k] == 0), k
    stepped = {k: p.detach().numpy() for k, p in tree_items(opt.params)}
    want = {k: v - lr * ref[k] for k, v in tree_items(start)}
    assert db(cat(stepped) - cat(want), cat(want)) <= -60.0


@pytest.mark.parametrize("name", ["simple_chain", "mastering_chain"])
def test_builder_first_fit_step_matches_grafx_tpu(name):
    """The README's two single-source builders (exact backend) through
    both packages' GraphParameterOptimizer, one source (1, 2, L): from
    grafx_tpu's seed-1 parameters plus 0.1 N(0, 1), towards the render of
    its init plus 0.3 N(0, 1), one step with SGD lr 1e-2 on the default
    MR-STFT loss; grafx_tpu's step is its jitted update.

    float32: the audio loss within -60 dB; the update (each parameter
    after the step less its start) within -40 dB, concatenated and each
    leaf grafx_tpu moves.  Its jitted update rounds otherwise than the
    port's eager step, and the loss's L1 term turns rounding into sign
    flips (test_mixing_console_first_step_matches_grafx_tpu), so the
    update is held in float64 too (grafx_tpu's step under jax.enable_x64,
    the port's processors, parameters and signals in double): there the
    loss and the concatenated update within -60 dB and each leaf within
    -40 dB.  Leaves grafx_tpu leaves in place stay in place."""
    import optax

    from grafx_tpu.models import GraphParameterOptimizer as JOptimizer

    lr = 1e-2
    G_j, procs_j = build(jconsole, name)
    rng = np.random.default_rng(7)
    init = jax.tree.map(np.asarray, JOptimizer(G_j, procs_j, key=jax.random.PRNGKey(1)).params)
    truth = jax.tree.map(lambda p: (p + 0.3 * rng.standard_normal(p.shape)).astype(np.float32), init)
    start = jax.tree.map(lambda p: (p + 0.1 * rng.standard_normal(p.shape)).astype(np.float32), init)
    x = (0.3 * rng.standard_normal((1, 2, L))).astype(np.float32)
    target = np.asarray(j_render(G_j, procs_j)(x, truth)[0])
    cat = lambda g: np.concatenate([g[k].ravel() for k in sorted(g)])  # noqa: E731

    def check(audio, audio_j, moved, moved_j, whole_db):
        assert db(np.float64(audio) - float(audio_j), np.float64(audio_j)) <= -60.0
        assert moved.keys() == moved_j.keys()
        assert db(cat(moved) - cat(moved_j), cat(moved_j)) <= whole_db
        for k, ref in moved_j.items():
            if np.any(ref != 0):
                assert db(moved[k] - ref, ref) <= -40.0, (k, db(moved[k] - ref, ref))
            else:
                assert np.all(moved[k] == 0), k

    for dtype in (np.float32, np.float64):
        cast = lambda tree: jax.tree.map(lambda v: np.asarray(v, dtype), tree)  # noqa: E731,B023
        with jax.enable_x64(dtype == np.float64):
            opt_j = JOptimizer(G_j, procs_j, optimizer=optax.sgd(lr), key=jax.random.PRNGKey(1))
            opt_j.params = jax.tree.map(jnp.asarray, cast(start))
            _, audio_j = opt_j.step(jnp.asarray(x, dtype), jnp.asarray(target, dtype))
            moved_j = {k: np.asarray(v, np.float64) - s for (k, v), (_, s) in
                       zip(tree_items(opt_j.params), tree_items(cast(start)))}
        G, procs = build(console, name)
        if dtype == np.float64:
            for proc in procs.values():
                proc.double()
        opt = GraphParameterOptimizer(G, procs, optimizer=lambda ps: torch.optim.SGD(ps, lr=lr),
                                      device="cpu", jit=False)
        if dtype == np.float32:  # the port's own step
            with torch.no_grad():
                tree_map(lambda p, v: p.copy_(v), opt.params, parameters_from_numpy(start))
            total, audio = opt.step(torch.tensor(x), torch.tensor(target))
            after = {k: p.detach() for k, p in tree_items(opt.params)}
        else:  # the optimizer binds its own leaves: SGD's step from the gradient of its loss
            opt.params = tree_map(lambda v, p: torch.tensor(v).requires_grad_(p.requires_grad),
                                  cast(start), opt.params)
            total, audio = opt.loss(torch.tensor(x.astype(dtype)), torch.tensor(target.astype(dtype)))
            total.backward()
            after = {k: p.detach() - lr * p.grad if p.grad is not None else p.detach()
                     for k, p in tree_items(opt.params)}
        assert total.item() == audio.item()  # no aux loss in these chains
        moved = {k: after[k].numpy().astype(np.float64) - s for k, s in tree_items(cast(start))}
        check(audio.item(), audio_j, moved, moved_j, -40.0 if dtype == np.float32 else -60.0)


def predictor_case():
    """The predictor of the 3-track console with grafx_tpu's init weights
    (as numpy) loaded into the port, each package's features (tracks:
    their stem's, bus and send: the mix's)."""
    G_j, procs_j, _, x, target = console_case(seed=1)
    G, procs = mixing_console(num_tracks=TRACKS, ir_len=IR_LEN)
    pred_j = JPredictor(procs_j, feature_dim=64, hidden=32)
    weights = pred_j.init(jax.random.PRNGKey(1))
    pred = ParameterPredictor(procs, feature_dim=64, hidden=32)
    pred.load_numpy(jax.tree.map(np.asarray, weights))
    mix = x.sum(0, keepdims=True)
    feats = audio_features(torch.tensor(np.concatenate([x, mix])))
    feats_j = np.asarray(j_audio_features(jnp.asarray(np.concatenate([x, mix]))))
    per_type = features_per_type(G, procs, feats[:TRACKS], feats[TRACKS])
    per_type_j = features_per_type(G, procs, torch.tensor(feats_j[:TRACKS]),
                                   torch.tensor(feats_j[TRACKS]))
    return dict(G=G, procs=procs, G_j=G_j, procs_j=procs_j, pred=pred, pred_j=pred_j,
                weights=weights, feats=feats, feats_j=feats_j, per_type=per_type,
                per_type_j={t: jnp.asarray(v.numpy()) for t, v in per_type_j.items()},
                x=x, target=target)


def test_predictor_matches_grafx_tpu():
    """grafx_tpu's weights carried across (w1, w2 transposed into
    nn.Linear): the features within 1e-5 relative, every predicted leaf
    within 1e-5 relative, and the MR-STFT loss of the rendered prediction
    within 1e-5 relative."""
    c = predictor_case()
    assert max_rel(c["feats"].numpy(), c["feats_j"]) <= 1e-5
    with torch.no_grad():
        predicted = c["pred"](c["per_type"])
    predicted_j = c["pred_j"].apply(c["weights"], c["per_type_j"])
    ref = dict(tree_items(jax.tree.map(np.asarray, predicted_j)))
    got = {k: v.numpy() for k, v in tree_items(predicted)}
    assert got.keys() == ref.keys()
    for k in ref:
        assert max_rel(got[k], ref[k]) <= 1e-5, k
    plan = prepare_render(reorder_for_fast_render(convert_to_tensor(c["G"]), method="beam"))
    with torch.no_grad():
        out = make_render_fn(c["procs"], plan, jit=False)(torch.tensor(c["x"]), predicted)[0]
        loss = multi_resolution_stft_loss(out, torch.tensor(c["target"])).item()
    loss_j = float(j_mrstft(j_render(c["G_j"], c["procs_j"])(c["x"], predicted_j)[0], c["target"]))
    assert loss == pytest.approx(loss_j, rel=1e-5)


def test_predictor_init_draws_as_grafx_tpu():
    """init's layout and scales: w ~ N(0, 1) / sqrt(fan-in) drawn as
    (in, out), biases 0; one MLP per type with parameter_size()'s leaves
    in their dict order."""
    _, procs = mixing_console(num_tracks=TRACKS, ir_len=IR_LEN)
    pred = ParameterPredictor(procs, feature_dim=64, hidden=128,
                              generator=torch.Generator().manual_seed(5))
    again = ParameterPredictor(procs, feature_dim=64, hidden=128,
                               generator=torch.Generator().manual_seed(5))
    ref = JPredictor(procs, feature_dim=64, hidden=128)
    assert list(pred.specs) == list(ref.specs) and pred.specs == ref.specs
    for t, mlp in pred.mlps.items():
        first, last = mlp[0], mlp[2]
        assert torch.equal(first.weight, again.mlps[t][0].weight)
        assert first.weight.shape == (128, 64) and not first.bias.any() and not last.bias.any()
        assert last.out_features == sum(int(np.prod(s)) for _, s in ref.specs[t])
        assert 0.8 < first.weight.std().item() * 8 < 1.2  # N(0, 1) / sqrt(64)
    with pytest.raises(ValueError, match="types"):
        pred.load_numpy({"eq": {}})


def test_predictor_trains_through_the_render():
    """The counterpart of tests/test_models.py:49: three dist -> gain
    chains, every node conditioned on its source's features, 60 Adam
    (3e-3) steps through the render halve the MSE."""
    G = GRAFX(config=NodeConfigs(["gain", "dist"]))
    ends = [G.add_serial_chain(["in", "dist", "gain"])[1] for _ in range(3)]
    mix = G.add("mix")
    for e in ends:
        G.connect(e, mix)
    G.connect(mix, G.add("out"))
    processors = {"gain": StereoGain(), "dist": TanhDistortion()}
    plan = prepare_render(reorder_for_fast_render(convert_to_tensor(G), method="beam"))
    render = make_render_fn(processors, plan, jit=False)
    x = torch.tensor((0.3 * np.random.default_rng(0).standard_normal((3, 2, 2**11))).astype(np.float32))
    target = 0.1 * x.sum(0, keepdim=True)
    feats = audio_features(x, n_fft=256, hop=128, num_bands=16)  # (3, 32)
    predictor = ParameterPredictor(processors, feature_dim=32, hidden=32,
                                   generator=torch.Generator().manual_seed(1))
    per_type = {"gain": feats, "dist": feats}
    opt = torch.optim.Adam(predictor.parameters(), lr=3e-3)
    losses = []
    for _ in range(60):
        opt.zero_grad()
        loss = torch.mean((render(x, predictor(per_type))[0] - target) ** 2)
        loss.backward()
        opt.step()
        losses.append(loss.item())
    assert losses[-1] < losses[0] * 0.5, (losses[0], losses[-1])


def test_small_helpers_match_grafx_tpu():
    """rms_difference against grafx_tpu's (1e-6 relative);
    accepts_noise_key by explicit name only (an nn.Module through its
    forward)."""
    rng = np.random.default_rng(9)
    X, Y = (rng.standard_normal((4, 2, 512)).astype(np.float32) * s for s in (1.0, 0.3))
    assert rms_difference(torch.tensor(X), torch.tensor(Y)).item() == pytest.approx(
        float(j_rms_difference(jnp.asarray(X), jnp.asarray(Y))), rel=1e-6)

    class Noisy(torch.nn.Module):
        def forward(self, x, noise_key=None):
            return x

    def kwargs_only(x, **kwargs):
        return x

    assert accepts_noise_key(Noisy()) and accepts_noise_key(lambda x, noise_key: x)
    assert not accepts_noise_key(StereoGain()) and not accepts_noise_key(kwargs_only)
    assert "noise_key" not in inspect.signature(StereoGain().forward).parameters
