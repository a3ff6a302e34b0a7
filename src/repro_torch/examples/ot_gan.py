"""OT-GAN with adversarially learned positive-feature kernels (paper §4).

    PYTHONPATH=src python -m repro_torch.examples.ot_gan [--steps 300]
        [--batch 256] [--r 128] [--iters 40] [--nc 3] [--pixels]
        [--eval-kernel] [--strict] [--device cuda|cpu]

The paper's Eq. (18) objective at small scale:

    min_rho  max_{gamma, theta}  Wbar_{eps, c_theta o h_gamma}(g_rho(z), data)

* g_rho     — generator MLP z -> x, widths [16, 128, 128, x_dim]
* h_gamma   — adversarial embedding MLP x -> B(0, 3) in R^8, [x_dim, 64, 8]
* phi_theta — Lemma-1 Gaussian positive features with LEARNED anchors

The loss is one :class:`~repro_torch.core.OTObjective` under the training
policy (bf16 factors): the embedded clouds and the anchors form a
``GaussianPointCloud``, the divergence runs three solves through the log
plan (on the card: the feature map, then 8 iterations per launch of the
megakernel ``log_sinkhorn_block`` where it is admitted, as at the default
batch 256 and r = 128), and the gradients come from the envelope-theorem
VJP. Each step is plain signed SGD: ``n_c`` adversary steps (ascent on the
embedding and the anchors, lr 1e-3) then one generator step (descent,
lr 3e-3), parameters updated in place. Default target: the 8-mode ring in
R^2; ``--pixels`` a 12x12 two-moons image domain.

``--strict`` is the train-smoke contract: the Gaussian plan was selected
at bf16, every Wbar is finite, the mean Wbar of the last k steps is below
that of the first k, and on the card the megakernel's launch counter rose
by ``3 * ceil(iters / 8)`` a step (on the CPU the kernels run their plain
versions and launch nothing). The JAX example also asserts zero
post-warmup retraces of its jitted step; PyTorch runs eagerly and traces
nothing, so that check has no counterpart here.

Counterpart of ``examples/ot_gan.py`` (same configuration, same schedule;
``repro_torch.convert.gan_params`` carries its parameters across).
"""
from __future__ import annotations

import argparse
import math
import time
from typing import Dict, List, Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ..core import ExecutionPolicy, GaussianFeatureMap, OTObjective
from ..core.features import gaussian_log_features
from ..kernels import log_sinkhorn_block
from ..kernels.backend import resolve_device
from ..kernels.ops import observe_plan_selection

LATENT_Z = 16
LATENT_D = 8         # the embedding's output dimension
EPS = 0.5
R_BALL = 3.0
LR_G, LR_ADV = 3e-3, 1e-3
SIGNS = {"gen": -1.0, "emb": 1.0, "anchors": 1.0}


def _trunc_normal(shape, std: float, generator: torch.Generator):
    """std * N(0, 1) truncated to [-2, 2], by inverting the CDF."""
    lo = 0.5 * (1.0 + math.erf(-2.0 / math.sqrt(2.0)))
    u = lo + (1.0 - 2.0 * lo) * torch.rand(shape, generator=generator,
                                           device=generator.device)
    return std * math.sqrt(2.0) * torch.erfinv(2.0 * u - 1.0)


class MLP(nn.Module):
    """``x @ w + b`` layers with tanh-approximated GELU between them (the
    JAX example's ``mlp_apply``; ``nn.Linear.weight`` is ``w.T``)."""

    def __init__(self, dims: Sequence[int], *,
                 generator: Optional[torch.Generator] = None, device=None):
        super().__init__()
        self.layers = nn.ModuleList(
            nn.Linear(a, b, device=device) for a, b in zip(dims[:-1], dims[1:]))
        if generator is not None:
            with torch.no_grad():
                for lin in self.layers:
                    w = _trunc_normal(lin.weight.shape,
                                      math.sqrt(2.0 / lin.in_features),
                                      generator)
                    lin.weight.copy_(w)
                    lin.bias.zero_()

    def forward(self, x: torch.Tensor, final_tanh: bool = False):
        for i, lin in enumerate(self.layers):
            x = lin(x)
            if i < len(self.layers) - 1:
                x = F.gelu(x, approximate="tanh")
        return torch.tanh(x) if final_tanh else x


class OTGAN(nn.Module):
    """Generator, adversarial embedding and learnable Lemma-1 anchors."""

    def __init__(self, gen: MLP, emb: MLP, anchors: torch.Tensor):
        super().__init__()
        self.gen, self.emb = gen, emb
        self.anchors = nn.Parameter(anchors)

    @classmethod
    def init(cls, x_dim: int, r: int, generator: torch.Generator,
             device) -> "OTGAN":
        """Random weights from ``generator`` (a CPU generator, so the
        weights do not depend on the device), moved to ``device``."""
        gen = MLP([LATENT_Z, 128, 128, x_dim], generator=generator)
        emb = MLP([x_dim, 64, LATENT_D], generator=generator)
        fm = GaussianFeatureMap(r=r, d=LATENT_D, eps=EPS, R=R_BALL)
        return cls(gen, emb, fm.init(generator)).to(device)

    def embed(self, pts: torch.Tensor) -> torch.Tensor:
        """h_gamma: the adversarial tower into B(0, R_BALL)."""
        return self.emb(pts, final_tanh=True) * R_BALL

    def group(self, name: str) -> List[nn.Parameter]:
        return [self.anchors] if name == "anchors" else \
            list(getattr(self, name).parameters())


def make_data(generator: torch.Generator, n: int, pixels: bool = False):
    """The 8-mode ring (radius 2, std 0.05) or 12x12 two-moons images, on
    the generator's device."""
    dev = generator.device
    if pixels:
        t = math.pi * torch.rand((n,), generator=generator, device=dev)
        moon = torch.rand((n,), generator=generator, device=dev) < 0.5
        cx = torch.where(moon, 0.5 + 0.4 * torch.cos(t), 0.5 - 0.4 * torch.cos(t))
        cy = torch.where(moon, 0.35 + 0.3 * torch.sin(t),
                         0.65 - 0.3 * torch.sin(t))
        grid = torch.linspace(0, 1, 12, device=dev)
        gy, gx = torch.meshgrid(grid, grid, indexing="ij")
        img = torch.exp(-(((gx[None] - cx[:, None, None]) ** 2
                           + (gy[None] - cy[:, None, None]) ** 2) / 0.01))
        return img.reshape(n, 144)
    mode = torch.randint(0, 8, (n,), generator=generator, device=dev)
    ang = 2 * math.pi * mode.float() / 8
    centers = torch.stack([torch.cos(ang), torch.sin(ang)], -1) * 2.0
    return centers + 0.05 * torch.randn((n, 2), generator=generator,
                                        device=dev)


def gan_losses(model: OTGAN, z: torch.Tensor, data: torch.Tensor,
               obj: OTObjective):
    """Eq. 18's inner term as one objective call: ``(Wbar, fake)``."""
    fake = model.gen(z)
    geom = obj.gaussian(model.embed(fake), model.embed(data), model.anchors,
                        R=R_BALL)
    return obj.divergence(geom), fake


def train_step(model: OTGAN, z: torch.Tensor, data: torch.Tensor,
               obj: OTObjective, *, adv: bool, lr_g: float = LR_G,
               lr_adv: float = LR_ADV):
    """One signed SGD step, in place: an adversary step ascends on the
    embedding and the anchors, a generator step descends on the generator.
    Only the updated group's gradients are taken. Returns the detached
    ``(Wbar, fake)`` before the update."""
    names = ("emb", "anchors") if adv else ("gen",)
    frozen = [p for n in SIGNS if n not in names for p in model.group(n)]
    for p in frozen:
        p.requires_grad_(False)
    try:
        d, fake = gan_losses(model, z, data, obj)
        params = [p for n in names for p in model.group(n)]
        grads = torch.autograd.grad(d, params)
    finally:
        for p in frozen:
            p.requires_grad_(True)
    with torch.no_grad():
        it = iter(grads)
        for n in names:
            step = SIGNS[n] * (lr_g if n == "gen" else lr_adv)
            for p in model.group(n):
                p.add_(step * next(it))
    return d.detach(), fake.detach()


def mode_coverage(fake: torch.Tensor) -> int:
    """Ring modes (of 8) hit by a sample within 0.5 of radius 2."""
    ang = torch.atan2(fake[:, 1], fake[:, 0])
    mode = torch.round(ang / (2 * math.pi / 8)).long() % 8
    ok = (torch.linalg.norm(fake[:, :2], dim=1) - 2.0).abs() < 0.5
    return int(torch.unique(mode[ok]).numel())


def _require(ok: bool, msg: str) -> None:
    """A --strict check; unlike ``assert`` it also runs under ``-O``."""
    if not ok:
        raise AssertionError(msg)


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--batch", type=int, default=256)
    ap.add_argument("--r", type=int, default=128)
    ap.add_argument("--iters", type=int, default=40,
                    help="Sinkhorn iterations per solve")
    ap.add_argument("--nc", type=int, default=3,
                    help="adversary steps per generator step (paper's n_c)")
    ap.add_argument("--pixels", action="store_true")
    ap.add_argument("--eval-kernel", action="store_true")
    ap.add_argument("--strict", action="store_true",
                    help="assert the bf16 Gaussian plan, the megakernel's "
                    "launches (on the card), finite and decreasing Wbar")
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu")
    return ap


def main(argv: Optional[Sequence[str]] = None) -> Dict:
    """Run the trainer; returns ``{"model", "divergences", "step_ms",
    "adv", "block_launches", "policy", "device"}`` (the per-step values as
    lists) for callers that drive it as a library."""
    args = _parser().parse_args(argv)
    device = resolve_device(args.device)
    x_dim = 144 if args.pixels else 2
    model = OTGAN.init(x_dim, args.r, torch.Generator().manual_seed(0), device)
    data_gen = torch.Generator(device=device).manual_seed(1)

    policy = ExecutionPolicy.training(use_pallas=True if args.strict else None)
    obj = OTObjective(eps=EPS, tol=0.0, max_iter=args.iters, policy=policy)
    print(f"[ot-gan] device={device} ot-policy {policy.describe()}")

    per_step_blocks = 3 * math.ceil(args.iters / 8)
    divergences, step_ms, advs, blocks = [], [], [], []
    t0 = time.perf_counter()
    with observe_plan_selection() as events:
        for step in range(args.steps):
            data = make_data(data_gen, args.batch, pixels=args.pixels)
            z = torch.randn((args.batch, LATENT_Z), generator=data_gen,
                            device=device)
            adv = step % (args.nc + 1) != args.nc   # n_c adversary : 1 gen
            before = log_sinkhorn_block.launches
            ts = time.perf_counter()
            d, fake = train_step(model, z, data, obj, adv=adv)
            divergences.append(float(d))           # waits for the card
            step_ms.append((time.perf_counter() - ts) * 1e3)
            advs.append(adv)
            blocks.append(log_sinkhorn_block.launches - before)
            if step % 50 == 0 or step == args.steps - 1:
                msg = f"[ot-gan] step {step:4d} Wbar={divergences[-1]:+.4f}"
                if not args.pixels:
                    msg += f" modes={mode_coverage(fake)}/8"
                print(msg + f" ({time.perf_counter() - t0:.1f}s)")

    if args.strict:
        sel = [e for e in events if e["geometry"] == "GaussianPointCloud"]
        _require(bool(sel), f"no fused plan selected for the GAN loss: "
                 f"{events}")
        _require(all(e["kind"] == "gaussian" and e["precision"] == "bf16"
                     for e in sel), f"plan selections {sel}")
        print(f"[ot-gan] strict: fused plan active ({sel[0]['kind']}/"
              f"{sel[0]['mode']}, precision=bf16, {len(sel)} solves)")
        if device.type == "cuda":
            _require(all(b == per_step_blocks for b in blocks),
                     f"megakernel launches per step {blocks}, expected "
                     f"{per_step_blocks}")
            print(f"[ot-gan] strict: {per_step_blocks} megakernel launches "
                  "a step")
        else:
            print("[ot-gan] strict: on the CPU the kernels run their plain "
                  "versions; no launch count to check")
        _require(all(math.isfinite(d) for d in divergences),
                 "non-finite Wbar")
        k = max(5, args.steps // 10)
        head = sum(divergences[:k]) / k
        tail = sum(divergences[-k:]) / k
        _require(tail < head, f"divergence did not decrease: first-{k} mean "
                 f"{head:.4f} -> last-{k} mean {tail:.4f}")
        print(f"[ot-gan] strict: finite losses, Wbar {head:.4f} -> "
              f"{tail:.4f} (decreasing)")

    if args.eval_kernel:
        q = GaussianFeatureMap(r=args.r, d=LATENT_D, eps=EPS, R=R_BALL).q
        data = make_data(data_gen, 64, pixels=args.pixels)
        noise = torch.randn((64, x_dim), generator=data_gen, device=device)

        @torch.no_grad()
        def k_mean(p, q_):
            lp = gaussian_log_features(model.embed(p), model.anchors,
                                       eps=EPS, q=q)
            lq = gaussian_log_features(model.embed(q_), model.anchors,
                                       eps=EPS, q=q)
            return float(torch.mean(torch.exp(lp) @ torch.exp(lq).T))
        print("learned kernel k_theta(f(x), f(y)) means "
              "(Table 1 analogue):")
        print(f"  data/data   = {k_mean(data, data):.4e}")
        print(f"  data/noise  = {k_mean(data, noise):.4e}")
        print(f"  noise/noise = {k_mean(noise, noise):.4e}")

    return dict(model=model, divergences=divergences, step_ms=step_ms, adv=advs,
                block_launches=blocks, policy=policy.describe(),
                device=str(device))


if __name__ == "__main__":
    main()
