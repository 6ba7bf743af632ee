"""checkpoint.py and GraphParameterOptimizer.save/restore of
grafx_tpu_torch: the graph's JSON text against grafx_tpu's, both ways;
session round trips; a resumed fit bit for bit the uninterrupted one; and
restore writing into the live tensors (a captured step holds them by
address)."""

import json

import numpy as np
import pytest
import torch

from grafx_tpu import checkpoint as jckpt
from grafx_tpu.data import convert_to_tensor as j_convert
from grafx_tpu.models import console as jconsole
from grafx_tpu_torch import checkpoint as ckpt
from grafx_tpu_torch.data import convert_to_tensor
from grafx_tpu_torch.models import GraphParameterOptimizer, console, mixing_console, simple_chain
from grafx_tpu_torch.ops.losses import mse_loss
from grafx_tpu_torch.utils import create_empty_parameters, tree_items, tree_map

L = 2**12
# builder name -> keyword arguments (small reverbs keep the tests quick)
BUILDERS = {
    "simple_chain": {},
    "mixing_console": {"num_tracks": 3, "ir_len": 2000},
    "mixing_console_delay": {"num_tracks": 3, "ir_len": 2000,
                             "track_chain": ("eq", "compressor", "gain", "delay")},
    "mastering_chain": {},
}


def build(package, name):
    builder = getattr(package, name.replace("_delay", ""))
    return builder(**BUILDERS[name])


def same_config_hash(*graphs):
    """``config_hash`` is ``hash()`` of the graph's NodeConfigs object,
    its identity, which differs between any two graphs built apart (in
    one package too); give the graphs one value so that their texts
    compare."""
    for G in graphs:
        G.graph["config_hash"] = 0


@pytest.mark.parametrize("name", list(BUILDERS))
def test_graph_json_text_equals_grafx_tpu(name):
    (G, _), (G_j, _) = build(console, name), build(jconsole, name)
    text, text_j = ckpt.graph_to_json(G), jckpt.graph_to_json(G_j)
    data, data_j = json.loads(text), json.loads(text_j)
    data["graph"].pop("config_hash")
    data_j["graph"].pop("config_hash")
    assert data == data_j
    same_config_hash(G, G_j)
    assert ckpt.graph_to_json(G) == jckpt.graph_to_json(G_j)


@pytest.mark.parametrize("name", list(BUILDERS))
def test_graph_from_json_crosses_between_the_packages(name):
    """grafx_tpu's text read by the port (and the port's by grafx_tpu)
    gives the same convert_to_tensor arrays and the same text again."""
    (G, _), (G_j, _) = build(console, name), build(jconsole, name)
    G2 = ckpt.graph_from_json(jckpt.graph_to_json(G_j))
    G2_j = jckpt.graph_from_json(ckpt.graph_to_json(G))
    for ours, theirs in ((G2, G_j), (G, G2_j)):
        t, t_j = convert_to_tensor(ours), j_convert(theirs)
        np.testing.assert_array_equal(t.node_types, np.asarray(t_j.node_types))
        np.testing.assert_array_equal(t.edge_indices, np.asarray(t_j.edge_indices))
        assert t.config.node_type_dict == t_j.config.node_type_dict
    assert G2.graph["config_hash"] == G_j.graph["config_hash"]
    same_config_hash(G2, G_j)
    assert ckpt.graph_to_json(G2) == jckpt.graph_to_json(G_j)


def test_session_round_trip(tmp_path):
    """save_session/load_session: the pickled graph, the parameters bit for
    bit (onto ``like``'s dtype where given) and the metadata."""
    G, processors = mixing_console(num_tracks=3, ir_len=2000)
    params = create_empty_parameters(processors, G, generator=torch.Generator().manual_seed(7))
    ckpt.save_session(str(tmp_path / "sess"), G, params, metadata={"step": 42})
    G2, params2, meta = ckpt.load_session(str(tmp_path / "sess"))
    assert meta == {"step": 42}
    assert ckpt.graph_to_json(G2) == ckpt.graph_to_json(G)
    for (k, a), (k2, b) in zip(tree_items(params), tree_items(params2)):
        assert k == k2 and b.device.type == "cpu" and torch.equal(a, b), k
    like = tree_map(lambda p: p.double(), params)
    _, params3, _ = ckpt.load_session(str(tmp_path / "sess"), like=like)
    assert all(p.dtype == torch.float64 for _, p in tree_items(params3))
    assert ckpt.load_session(str(tmp_path / "sess"))[2] == {"step": 42}
    ckpt.save_session(str(tmp_path / "bare"), G, params)
    assert ckpt.load_session(str(tmp_path / "bare"))[2] is None


def test_load_parameters_refuses_another_tree(tmp_path):
    path = str(tmp_path / "p.pt")
    ckpt.save_parameters(path, {"gain": {"log_gain": torch.zeros(3, 2)}})
    with pytest.raises(ValueError, match="do not match"):
        ckpt.load_parameters(path, like={"gain": {"log_gain": torch.zeros(4, 2)}})
    with pytest.raises(ValueError, match="do not match"):
        ckpt.load_parameters(path, like={"eq": {"log_gain": torch.zeros(3, 2)}})


def _gain_chain():
    G, processors = simple_chain(chain=("gain",))
    return GraphParameterOptimizer(G, processors, loss_fn=mse_loss, device="cpu")


def _console():
    G, processors = mixing_console(num_tracks=3, ir_len=2000)
    return GraphParameterOptimizer(G, processors, generator=torch.Generator().manual_seed(1),
                                   device="cpu")


def _inputs(name):
    rng = np.random.default_rng(1)
    if name == "gain_chain":  # tests/test_models.py:238
        x = rng.standard_normal((1, 2, 2**10)).astype(np.float32)
        return torch.tensor(x), torch.tensor(0.5 * x)
    x = rng.standard_normal((3, 2, L)).astype(np.float32)
    return torch.tensor(x), torch.tensor(rng.standard_normal((1, 2, L)).astype(np.float32))


@pytest.mark.parametrize("name, make, steps, at", [
    ("gain_chain", _gain_chain, 10, 4),
    ("mixing_console", _console, 6, 3),
])
def test_resumed_fit_is_bitwise_the_uninterrupted_one(tmp_path, name, make, steps, at):
    """The counterpart of tests/test_models.py:238: fit ``at`` steps, save,
    restore into a fresh optimizer (no state yet), fit the rest; the
    losses equal the uninterrupted fit's bit for bit (the gain chain with
    MSE as there, and the console with its defaults: MR-STFT, Adam)."""
    x, target = _inputs(name)
    full = make().fit(x, target, num_steps=steps)
    first = make()
    first.fit(x, target, num_steps=at)
    first.save(str(tmp_path / "ckpt"), metadata={"step": at})
    resumed = make()
    assert resumed.restore(str(tmp_path / "ckpt")) == {"step": at}
    assert resumed.fit(x, target, num_steps=steps - at) == full[at:]
    for (k, p), (_, q) in zip(tree_items(resumed.params), tree_items(first.params)):
        assert p.requires_grad == q.requires_grad, k


def _state_tensors(optimizer):
    return [(i, name, v) for i, p in enumerate(optimizer.param_groups[0]["params"])
            for name, v in optimizer.state[p].items()]


def test_restore_writes_into_the_live_tensors(tmp_path):
    """After a step (state made), restore keeps every parameter and every
    optimizer-state tensor the same object at the same address, with the
    saved values bit for bit (Adam's step count too)."""
    x, target = _inputs("mixing_console")
    saved = _console()
    saved.fit(x, target, num_steps=3)
    saved.save(str(tmp_path / "ckpt"))
    live = _console()
    live.step(x, target)
    params = [(k, p, p.data_ptr()) for k, p in tree_items(live.params)]
    state = [(i, name, v, v.data_ptr()) for i, name, v in _state_tensors(live.optimizer)]
    assert state and not torch.equal(state[0][2], _state_tensors(saved.optimizer)[0][2])
    live.restore(str(tmp_path / "ckpt"))
    for (k, p, ptr), (k2, p2) in zip(params, tree_items(live.params)):
        assert k == k2 and p2 is p and p.data_ptr() == ptr, k
        assert torch.equal(p.detach(), dict(tree_items(saved.params))[k].detach()), k
    after = _state_tensors(live.optimizer)
    assert len(after) == len(state) == len(_state_tensors(saved.optimizer))
    for (i, name, v, ptr), (_, _, v2), (_, _, ref) in zip(state, after, _state_tensors(saved.optimizer)):
        assert v2 is v and v.data_ptr() == ptr, (i, name)
        assert torch.equal(v, ref), (i, name)
    assert float(after[0][2]) == 3.0  # the step count of the first leaf


def test_restore_refuses_another_optimizer(tmp_path):
    x, target = _inputs("mixing_console")
    a = _console()
    a.step(x, target)
    a.save(str(tmp_path / "ckpt"))
    G, processors = mixing_console(num_tracks=3, ir_len=2000)
    other = GraphParameterOptimizer(G, processors, trainable={"reverb": False}, device="cpu")
    other.step(x, target)
    with pytest.raises(ValueError, match="parameter groups|holds parameters"):
        other.restore(str(tmp_path / "ckpt"))

