"""Gradient-based graph parameter estimation (the port of
:mod:`grafx_tpu.models.optimize` on ``torch.optim``).

One step is the canonical GRAFX training loop: render -> audio loss +
aux losses -> backward -> optimizer step.  ``grafx_tpu`` jits the whole
update; here, with ``jit=True`` on the card, the whole update (zero-grad,
forward, loss, backward and ``optimizer.step()``) replays one CUDA graph
(:class:`~grafx_tpu_torch.render.compiled.CapturedFunction`, PyTorch's
whole-network capture recipe).
"""

import os

import torch

from grafx_tpu_torch import checkpoint
from grafx_tpu_torch.data import convert_to_tensor
from grafx_tpu_torch.ops.losses import (
    multi_resolution_stft_loss,
    multi_resolution_stft_loss_precomputed,
    precompute_stft_targets,
)
from grafx_tpu_torch.render import (
    CapturedFunction,
    check_capturable,
    fuse_parameters,
    fuse_serial_lti,
    make_render_fn,
    prepare_render,
    reorder_for_fast_render,
)
from grafx_tpu_torch.utils import (
    check_device,
    create_empty_parameters,
    tree_items,
    tree_leaves,
    tree_map,
)

OPT_STATE_FILE = "opt_state.pt"


def _adam(params):
    """Adam, lr 1e-2; ``capturable`` (the same update, its step count on
    the device) where the parameters are on the card, which torch refuses
    for CPU parameters."""
    params = list(params)
    return torch.optim.Adam(params, lr=1e-2, capturable=any(p.is_cuda for p in params))


class GraphParameterOptimizer:
    """Fit a graph's processor parameters to match target audio.

    Args:
        G: a :class:`GRAFX` graph.
        processors: type -> processor mapping.
        loss_fn: ``f(output, target) -> scalar`` (default:
            multi-resolution STFT loss, whose target spectrograms are then
            computed once per target tensor, eagerly, outside any captured
            step, which takes them as an argument).
        optimizer: a factory ``f(list of tensors) -> torch.optim.Optimizer``
            (default: Adam with lr 1e-2).  It receives the trainable
            leaves only, so frozen leaves are never updated.  With ``jit``
            on the card its ``step()`` must be capturable
            (:func:`~grafx_tpu_torch.render.compiled.check_capturable`;
            else the constructor raises), and its hyper-parameters are
            read once, at capture.
        trainable: optional freezing spec: a type-level dict
            ``{"eq": True, "reverb": False, ...}`` (missing types train)
            or a full boolean tree with the parameters' structure.
            Frozen leaves get ``requires_grad=False`` and keep their
            initial values bit for bit.  Every ``_absent`` member mask is
            frozen whatever the spec says: it is structure, not a weight.
        aux_weight: weight of the summed aux (intermediates) losses.
        method: scheduling method.
        generator: ``torch.Generator`` for the initial parameters
            (default: seeded with 0).
        fuse: ``False``, ``True``, ``"pad"`` or ``"pad-auto"``: apply
            :func:`~grafx_tpu_torch.render.fuse_serial_lti` first
            (``dynamics_pad`` off, off, on, ``"auto"``).  Parameters are
            drawn on the ORIGINAL graph and migrated with
            :func:`~grafx_tpu_torch.render.fuse_parameters`, so padded
            members start absent with zero rows (drawing them on the fused
            graph would make every padded member present and train it).
        device: where the parameters, the processors and the step live
            (default the card; ``"cpu"`` must be asked for, and ``"cuda"``
            without a card raises).
        jit: on the card, :meth:`step` replays one captured CUDA graph of
            the whole update per input and target shapes (the first step
            of a shape runs eagerly, the second captures), and
            :meth:`render_current` a captured render; ``False`` runs every
            step eagerly (the kernels' launch counters then count every
            step).  The CPU runs eagerly either way.
    """

    def __init__(
        self,
        G,
        processors,
        loss_fn=multi_resolution_stft_loss,
        optimizer=None,
        trainable=None,
        aux_weight=1.0,
        method="beam",
        generator=None,
        fuse=False,
        device="cuda",
        jit=True,
    ):
        device = check_device(device)
        G_unfused = processors_unfused = None
        if fuse:
            G_unfused, processors_unfused = G, processors
            G, processors = fuse_serial_lti(
                G,
                processors,
                dynamics_pad=("auto" if fuse == "pad-auto" else (fuse == "pad")),
            )
        self.G = G
        self.processors = processors
        self._precompute_target = loss_fn is multi_resolution_stft_loss
        if self._precompute_target:
            loss_fn = multi_resolution_stft_loss_precomputed
            self._target_cache = (None, None)  # (target tensor, its spectrograms)
        self.loss_fn = loss_fn
        self.aux_weight = aux_weight

        G_t = reorder_for_fast_render(convert_to_tensor(G), method=method)
        self.render_data = prepare_render(G_t)
        for proc in processors.values():
            proc.to(device)
        # the step differentiates through the render (and is captured whole)
        self.render = make_render_fn(processors, self.render_data, jit=False)
        self._render_jit = make_render_fn(processors, self.render_data, jit=jit)

        if G_unfused is not None:
            params = fuse_parameters(
                create_empty_parameters(processors_unfused, G_unfused, generator=generator),
                G_unfused, G, processors, method=method,
            )
        else:
            params = create_empty_parameters(processors, G, generator=generator)
        mask = (
            self._trainable_mask(trainable, params)
            if trainable is not None
            else tree_map(lambda _: True, params)
        )
        mask = self._freeze_absent(mask)
        self.params = tree_map(lambda p, m: p.to(device).requires_grad_(bool(m)), params, mask)
        self.optimizer = (optimizer or _adam)(
            [p for p in tree_leaves(self.params) if p.requires_grad]
        )
        self._update = self._eager_update
        if jit:
            if device.type == "cuda":
                check_capturable(self.optimizer)
            self._update = CapturedFunction(self._eager_update, name="GraphParameterOptimizer.step")

    @staticmethod
    def _freeze_absent(mask):
        """Set every ``_absent`` subtree of a boolean mask to ``False``."""
        if not isinstance(mask, dict):
            return mask
        return {
            k: tree_map(lambda _: False, v) if k == "_absent"
            else GraphParameterOptimizer._freeze_absent(v)
            for k, v in mask.items()
        }

    @staticmethod
    def _trainable_mask(trainable, params):
        """Expand a ``trainable`` spec to a boolean tree over ``params``."""
        if isinstance(trainable, dict) and all(isinstance(v, bool) for v in trainable.values()):
            unknown = set(trainable) - set(params)
            if unknown:
                raise ValueError(
                    f"trainable names unknown processor types {sorted(unknown)};"
                    f" graph has {sorted(params)}"
                )
            return {
                t: tree_map(lambda _, flag=bool(trainable.get(t, True)): flag, sub)
                for t, sub in params.items()
            }
        return trainable

    def _loss_target(self, target):
        """The loss's target: with the default MR-STFT loss its
        spectrograms, computed once per target tensor (by identity)."""
        if not self._precompute_target:
            return target
        cached, specs = self._target_cache
        if cached is not target:
            with torch.no_grad():
                specs = precompute_stft_targets(target)
            self._target_cache = (target, specs)
        return specs

    def _loss(self, input_signals, loss_target):
        out, intermediates, _ = self.render(input_signals, self.params)
        audio = self.loss_fn(out, loss_target)
        aux = sum(v.sum() for inter in intermediates for v in tree_leaves(inter))
        return audio + self.aux_weight * aux, audio

    def loss(self, input_signals, target):
        """``(total_loss, audio_loss)`` at the current parameters,
        differentiable in them; ``total = audio + aux_weight * aux``."""
        return self._loss(input_signals, self._loss_target(target))

    def _eager_update(self, input_signals, loss_target):
        self.optimizer.zero_grad(set_to_none=True)
        total, audio = self._loss(input_signals, loss_target)
        total.backward()
        self.optimizer.step()
        return total.detach(), audio.detach()

    def step(self, input_signals, target):
        """One optimization step; returns ``(total_loss, audio_loss)``
        (detached scalars, fresh on every call).  The parameters and their
        ``.grad`` are updated in place."""
        return self._update(input_signals, self._loss_target(target))

    def fit(self, input_signals, target, num_steps=100, log_every=0):
        """Run ``num_steps`` updates; returns the audio-loss history."""
        history = []
        for i in range(num_steps):
            _, audio = self.step(input_signals, target)
            history.append(float(audio))
            if log_every and (i % log_every == 0):
                print(f"step {i}: audio_loss={history[-1]:.6f}")
        return history

    def save(self, directory, metadata=None):
        """Checkpoint the whole optimization state (graph, parameters and
        the optimizer's state) for an exact resume by :meth:`restore`."""
        checkpoint.save_session(directory, self.G, self.params, metadata)
        checkpoint.save_parameters(
            os.path.join(directory, OPT_STATE_FILE), self.optimizer.state_dict()
        )

    def restore(self, directory):
        """Load a checkpoint from :meth:`save` into this optimizer, which
        must be built with the same graph, processors and optimizer
        configuration; a resumed :meth:`fit` continues the saved
        trajectory.  Returns the saved metadata (or ``None``).

        Every saved value is copied IN PLACE into the existing parameter
        and optimizer-state tensors (Adam's ``step`` too, a device tensor
        when ``capturable``): a captured step (``jit``) replays on those
        tensors by address, and new tensors would leave it updating
        tensors that nothing reads.  An optimizer that has no state yet
        (no step taken, so nothing captured) loads it as torch does."""
        _, params, metadata = checkpoint.load_session(directory, like=self.params)
        saved = torch.load(
            os.path.join(directory, OPT_STATE_FILE), map_location="cpu", weights_only=True
        )
        writes = self._state_writes(saved) if self.optimizer.state else None
        with torch.no_grad():
            for (_, p), (_, v) in zip(tree_items(self.params), tree_items(params)):
                p.copy_(v)
            if writes is None:
                self.optimizer.load_state_dict(saved)
                return metadata
            for live, value in writes:
                live.copy_(value)
        for group, saved_group in zip(self.optimizer.param_groups, saved["param_groups"]):
            group.update({k: v for k, v in saved_group.items() if k != "params"})
        return metadata

    def _state_writes(self, saved):
        """``[(live state tensor, saved value)]`` for an optimizer that has
        state, raising unless ``saved`` holds the same state entries of
        the same shapes."""
        groups = self.optimizer.param_groups
        if [len(g["params"]) for g in groups] != [len(g["params"]) for g in saved["param_groups"]]:
            raise ValueError("the saved optimizer state has other parameter groups")
        params = [p for g in groups for p in g["params"]]
        have = {i for i, p in enumerate(params) if p in self.optimizer.state}
        if have != set(saved["state"]):
            raise ValueError(
                f"the saved optimizer state holds parameters {sorted(saved['state'])},"
                f" this optimizer {sorted(have)}"
            )
        writes = []
        for i, values in saved["state"].items():
            state = self.optimizer.state[params[i]]
            if set(state) != set(values):
                raise ValueError(f"parameter {i}: saved state {sorted(values)}, live {sorted(state)}")
            for name, v in values.items():
                if tuple(v.shape) != tuple(state[name].shape):
                    raise ValueError(f"parameter {i}: {name} saved as {tuple(v.shape)},"
                                     f" live {tuple(state[name].shape)}")
                writes.append((state[name], v))
        return writes

    def render_current(self, input_signals):
        """Render with the current parameters (no gradient; compiled with
        ``jit``, like ``grafx_tpu``'s ``_render_jit``)."""
        with torch.no_grad():
            return self._render_jit(input_signals, self.params)[0]
