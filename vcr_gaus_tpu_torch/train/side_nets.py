"""The trainer's side networks (the JAX Trainer's ``NetState``): the
decoupled appearance network with its per-image embeddings, and the
semantic classifier, each with the JAX package's optimizer,
``optax.adam(lr, eps=1e-15)``, written on tensors.

Their state travels as plain dicts of numpy, keyed as the JAX package's
``NetState`` fields: parameters in the flax layout, an Adam state as
``{"count", "mu", "nu"}`` (a JAX checkpoint's optax tuple
``(ScaleByAdamState(count, mu, nu), EmptyState())`` reads the same way).
"""

from __future__ import annotations

import numpy as np
import torch

from ..models import appearance as APP

NET_FIELDS = ("app_embeddings", "app_params", "app_opt", "cls_params",
              "cls_opt")


class Adam:
    """optax.adam(lr, b1, b2, eps) on a list of tensors, updated in place:
    an integer count; mu = (1 - b1) g + b1 mu, nu = (1 - b2) g^2 + b2 nu;
    the bias corrections 1 - b^count in float32; the update
    mu_hat / (sqrt(nu_hat) + eps), scaled by -lr and added to the
    parameter."""

    def __init__(self, params: list[torch.Tensor], lr: float, b1=0.9,
                 b2=0.999, eps=1e-15):
        self.params = params
        self.lr, self.b1, self.b2, self.eps = float(lr), b1, b2, eps
        self.count = 0
        self.mu = [torch.zeros_like(p) for p in params]
        self.nu = [torch.zeros_like(p) for p in params]

    @torch.no_grad()
    def step(self, grads: list[torch.Tensor]) -> None:
        self.count += 1
        c = np.float32(self.count)
        bc1 = float(np.float32(1) - np.power(np.float32(self.b1), c))
        bc2 = float(np.float32(1) - np.power(np.float32(self.b2), c))
        for p, g, m, v in zip(self.params, grads, self.mu, self.nu):
            m.copy_((1 - self.b1) * g + self.b1 * m)
            v.copy_((1 - self.b2) * (g * g) + self.b2 * v)
            u = (m / bc1) / (torch.sqrt(v / bc2) + self.eps)
            p.add_(u * -self.lr)


def _numpy(t: torch.Tensor) -> np.ndarray:
    """A host copy of ``t`` (never a view of a CPU tensor)."""
    return t.detach().cpu().numpy().copy()


def _adam_dict(opt) -> dict:
    """An Adam state as {count, mu, nu}, from either package's form."""
    if isinstance(opt, dict):
        return opt
    state = opt[0]                  # (ScaleByAdamState, EmptyState)
    return {"count": state.count, "mu": state.mu, "nu": state.nu}


class SideNets:
    """The appearance network and embeddings (``use_decoupled_appearance``)
    and the semantic classifier (``ch_sem`` > 0), each with its Adam; either
    may be absent. Initialized from ``gen``; ``step`` updates them in
    place."""

    def __init__(self, cfg, n_images: int, ch_sem: int, num_cls: int,
                 gen: torch.Generator, device: torch.device):
        self.device = device
        self.emb = self.app = self.cls = None
        self.app_opt = self.cls_opt = None
        if cfg.model.use_decoupled_appearance:
            self.emb, self.app = APP.init_appearance(n_images, gen, device)
            self.emb.requires_grad_(True)
            self.app_opt = Adam([self.emb, *self.app.parameters()],
                                cfg.optim.appearance_embeddings_lr)
        if ch_sem:
            self.cls = APP.init_classifier(ch_sem, num_cls, gen, device)
            self.cls_opt = Adam(list(self.cls.parameters()), cfg.optim.cls_lr)

    def leaves(self) -> list[torch.Tensor]:
        """The tensors a step differentiates, in ``step``'s order."""
        return [*(self.app_opt.params if self.app_opt else []),
                *(self.cls_opt.params if self.cls_opt else [])]

    def step(self, grads: list[torch.Tensor]) -> None:
        """One Adam step of each network from the gradients of
        ``leaves()``."""
        n = len(self.app_opt.params) if self.app_opt else 0
        if self.app_opt:
            self.app_opt.step(grads[:n])
        if self.cls_opt:
            self.cls_opt.step(grads[n:])

    # -- the JAX layout ------------------------------------------------------

    def _opt_state(self, opt: Adam, module, with_emb: bool) -> dict:
        def tree(tensors):
            by_param = dict(zip(opt.params, tensors))
            flax = APP.to_flax(module, by_param)
            if not with_emb:
                return flax
            return (_numpy(by_param[self.emb]), flax)
        return {"count": np.asarray(opt.count, np.int32),
                "mu": tree(opt.mu), "nu": tree(opt.nu)}

    def state_dict(self) -> dict:
        """{NET_FIELDS: numpy trees or None}: parameters in the flax layout,
        Adam states as {count, mu, nu}."""
        out = dict.fromkeys(NET_FIELDS)
        if self.app is not None:
            out["app_embeddings"] = _numpy(self.emb)
            out["app_params"] = APP.to_flax(self.app)
            out["app_opt"] = self._opt_state(self.app_opt, self.app, True)
        if self.cls is not None:
            out["cls_params"] = APP.to_flax(self.cls)
            out["cls_opt"] = self._opt_state(self.cls_opt, self.cls, False)
        return out

    @torch.no_grad()
    def load_state_dict(self, net: dict) -> None:
        """Load the fields of either package's checkpoint (or of
        ``state_dict``); a network the state holds must exist here."""
        for field, have in (("app_params", self.app), ("cls_params",
                                                       self.cls)):
            if net.get(field) is not None and have is None:
                raise ValueError(f"the checkpoint holds {field}, which this "
                                 "recipe does not train")
        if self.app is not None:
            self.emb.copy_(torch.as_tensor(np.asarray(net["app_embeddings"])))
            APP.load_flax(self.app, net["app_params"])
            self._load_opt(self.app_opt, self.app, net["app_opt"], True)
        if self.cls is not None:
            APP.load_flax(self.cls, net["cls_params"])
            self._load_opt(self.cls_opt, self.cls, net["cls_opt"], False)

    def _load_opt(self, opt: Adam, module, state, with_emb: bool) -> None:
        st = _adam_dict(state)
        opt.count = int(np.asarray(st["count"]))
        for name, dst in (("mu", opt.mu), ("nu", opt.nu)):
            tree = st[name]
            by_param = APP.from_flax_tensors(
                module, tree[1] if with_emb else tree, self.device)
            if with_emb:
                by_param[self.emb] = torch.as_tensor(np.asarray(tree[0]),
                                                     device=self.device)
            for p, d in zip(opt.params, dst):
                d.copy_(by_param[p])

    def save_model(self) -> dict:
        """``model.pkl``'s content, as the JAX package writes it:
        {"appearance": (embeddings, flax params), "classifier": flax
        params}, each present when its network is."""
        side = {}
        if self.app is not None:
            side["appearance"] = (_numpy(self.emb),
                                  APP.to_flax(self.app))
        if self.cls is not None:
            side["classifier"] = APP.to_flax(self.cls)
        return side
