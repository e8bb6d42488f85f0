"""The paper's four benchmark networks (TapirXLA §IV): a small CNN, two
LSTMs (LSTM1: isolated digit recognition; LSTM2: continuous speech) and
NCF (neural collaborative filtering, He et al.), at the reference's sizes.

The port of the JAX package's ``models/paper_nets.py``.  They drive
``launch/fig3.py``, the paper's one table: a training step under
``mode="opaque"`` (the stock-XLA control) against ``mode="tapir"``.  The
LSTM cell is the paper's sweet spot: eight GEMM library calls in opaque
mode, one fused GEMM in tapir mode.

Parameters are a plain tree (dicts and lists of fp32 tensors) passed to
``forward`` / ``loss``, as in the reference.  ``init(generator, device)``
draws them from a torch generator (the reference's ``jax.random`` draws
cannot be reproduced; ``models.convert.paper_params_from_numpy`` carries
the reference's own weights across).  Every product runs through the
tapir ops, so on a CUDA tensor it is a launch of the hand-written GEMM.
Activations stay NHWC, as in the reference: the CNN's flatten of
``[B, 7, 7, 64]`` meets ``w3``'s rows in (row, column, channel) order.
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import torch
import torch.nn.functional as F

from ..core import tapir
from .base import resolve_device


def _materialize(spec, generator: torch.Generator, device):
    """A parameter tree from its spec tree: each leaf ``(shape, scale)``
    becomes ``normal * scale`` (zeros where the scale is 0), drawn in the
    order the spec lists them."""
    if isinstance(spec, list):
        return [_materialize(s, generator, device) for s in spec]
    if isinstance(spec, dict):
        return {k: _materialize(v, generator, device) for k, v in spec.items()}
    shape, scale = spec
    if scale == 0.0:
        return torch.zeros(shape, device=device)
    return torch.randn(shape, generator=generator, device=device) * scale


class _PaperNet:
    """``init`` from the subclass's ``param_spec``."""

    def param_spec(self):
        raise NotImplementedError

    def init(self, generator: torch.Generator = None, device="cuda"):
        dev = resolve_device(device)
        if generator is None:
            generator = torch.Generator(device=dev).manual_seed(0)
        return _materialize(self.param_spec(), generator, dev)


# ---------------------------------------------------------------------------
# CNN
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class CNNConfig:
    hw: int = 28
    in_ch: int = 1
    channels: tuple = (32, 64)
    fc: int = 128
    n_classes: int = 10


def max_pool_2x2(x: torch.Tensor) -> torch.Tensor:
    """2x2 max pool, stride 2, VALID, on NHWC (the reference's
    ``reduce_window`` max).  Its gradient goes to the FIRST maximum of each
    window in (row, column) order, as XLA's select-and-scatter gives it
    (``amax`` would split it between tied maxima: after a ReLU, windows of
    zeros are common)."""
    B, H, W, C = x.shape
    ho, wo = H // 2, W // 2
    win = (x[:, :2 * ho, :2 * wo].reshape(B, ho, 2, wo, 2, C)
           .permute(0, 1, 3, 5, 2, 4).reshape(B, ho, wo, C, 4))
    first = win.argmax(-1, keepdim=True)   # the first maximal entry
    return win.gather(-1, first).squeeze(-1)


class PaperCNN(_PaperNet):
    def __init__(self, cfg: CNNConfig = CNNConfig()):
        self.cfg = cfg

    def param_spec(self):
        cfg = self.cfg
        c1, c2 = cfg.channels
        flat = (cfg.hw // 4) * (cfg.hw // 4) * c2
        return {
            "k1": ((3, 3, cfg.in_ch, c1), 1 / math.sqrt(9 * cfg.in_ch)),
            "b1": ((c1,), 0.0),
            "k2": ((3, 3, c1, c2), 1 / math.sqrt(9 * c1)),
            "b2": ((c2,), 0.0),
            "w3": ((flat, cfg.fc), 1 / math.sqrt(flat)),
            "b3": ((cfg.fc,), 0.0),
            "w4": ((cfg.fc, cfg.n_classes), 1 / math.sqrt(cfg.fc)),
            "b4": ((cfg.n_classes,), 0.0),
        }

    def forward(self, params, x):
        """x: [B, H, W, in_ch] (NHWC) -> logits [B, n_classes]."""
        h = tapir.conv2d(x, params["k1"], params["b1"], activation="relu")
        h = max_pool_2x2(h)
        h = tapir.conv2d(h, params["k2"], params["b2"], activation="relu")
        h = max_pool_2x2(h)
        h = h.reshape(h.shape[0], -1)
        return _cnn_fc_head(h, params["w3"], params["b3"],
                            params["w4"], params["b4"])

    def loss(self, params, batch):
        return _xent(self.forward(params, batch["x"]), batch["y"])


@tapir.parallel_region
def _cnn_fc_head(h, w3, b3, w4, b4):
    # module-level so the program cache keys stably on the call site: both
    # FC layers capture into one region graph (gelu and the bias adds fuse
    # into the GEMM epilogues) and repeat calls replay without re-tracing
    h = tapir.linear(h, w3, b3, activation="gelu")
    return tapir.linear(h, w4, b4)


# ---------------------------------------------------------------------------
# LSTM (LSTM1 / LSTM2 per Braun's benchmark framing)
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class LSTMConfig:
    input_dim: int = 39
    hidden: int = 256
    n_layers: int = 2
    n_classes: int = 10
    seq_len: int = 80
    per_step_output: bool = False   # LSTM2: per-frame classification


LSTM1 = LSTMConfig()
LSTM2 = LSTMConfig(input_dim=123, hidden=512, n_layers=3, n_classes=61,
                   seq_len=150, per_step_output=True)


class PaperLSTM(_PaperNet):
    def __init__(self, cfg: LSTMConfig = LSTM1):
        self.cfg = cfg

    def param_spec(self):
        cfg = self.cfg
        layers = []
        for li in range(cfg.n_layers):
            ind = cfg.input_dim if li == 0 else cfg.hidden
            layers.append({
                "W": ((ind + cfg.hidden, 4 * cfg.hidden),
                      1 / math.sqrt(ind + cfg.hidden)),
                "b": ((4 * cfg.hidden,), 0.0)})
        head = {"w": ((cfg.hidden, cfg.n_classes), 1 / math.sqrt(cfg.hidden)),
                "b": ((cfg.n_classes,), 0.0)}
        return {"layers": layers, "head": head}

    def forward(self, params, x):
        """x: [B, T, input_dim] -> logits [B, n_classes], or [B, T,
        n_classes] with ``per_step_output``.  The reference's ``lax.scan``
        over time is a loop of ``tapir.lstm_step`` calls here (PyTorch runs
        eagerly).  Each layer's input is split into its T steps once
        (``unbind``: under autograd one backward node stacks their
        gradients, where T ``x[:, t]`` would each zero-fill a whole one)."""
        cfg = self.cfg
        B = x.shape[0]
        h_seq = x
        for p in params["layers"]:
            h = x.new_zeros((B, cfg.hidden))
            c = x.new_zeros((B, cfg.hidden))
            hs = []
            for x_t in h_seq.unbind(1):
                h, c = tapir.lstm_step(x_t, h, c, p["W"], p["b"])
                hs.append(h)
            h_seq = torch.stack(hs, 1)
        head = params["head"]
        if cfg.per_step_output:
            return tapir.linear(h_seq, head["w"], head["b"])
        return tapir.linear(h, head["w"], head["b"])

    def loss(self, params, batch):
        return _xent(self.forward(params, batch["x"]), batch["y"])


# ---------------------------------------------------------------------------
# NCF (neural collaborative filtering)
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class NCFConfig:
    n_users: int = 6040       # MovieLens-1M
    n_items: int = 3706
    gmf_dim: int = 16
    mlp_dim: int = 32
    mlp_layers: tuple = (64, 32, 16, 8)


class PaperNCF(_PaperNet):
    def __init__(self, cfg: NCFConfig = NCFConfig()):
        self.cfg = cfg

    def param_spec(self):
        cfg = self.cfg
        p = {"ug": ((cfg.n_users, cfg.gmf_dim), 0.01),
             "ig": ((cfg.n_items, cfg.gmf_dim), 0.01),
             "um": ((cfg.n_users, cfg.mlp_dim), 0.01),
             "im": ((cfg.n_items, cfg.mlp_dim), 0.01),
             "mlp": []}
        ind = 2 * cfg.mlp_dim
        for width in cfg.mlp_layers:
            p["mlp"].append({"w": ((ind, width), 1 / math.sqrt(ind)),
                             "b": ((width,), 0.0)})
            ind = width
        p["out_w"] = ((cfg.gmf_dim + ind, 1), 0.1)
        p["out_b"] = ((1,), 0.0)
        return p

    def forward(self, params, users, items):
        """users / items: [N] ids -> logits [N].  The lookups are
        ``F.embedding``, whose CUDA backward sorts the ids and reduces each
        row's gradients in order: two runs give the same bits, where an
        indexing gather's backward would add with atomics."""
        gmf = (F.embedding(users, params["ug"])
               * F.embedding(items, params["ig"]))
        h = torch.cat([F.embedding(users, params["um"]),
                       F.embedding(items, params["im"])], dim=-1)
        h = _ncf_mlp_tower(h, params["mlp"])
        z = torch.cat([gmf, h], dim=-1)
        return tapir.linear(z, params["out_w"], params["out_b"])[..., 0]

    def loss(self, params, batch):
        logit = self.forward(params, batch["users"], batch["items"])
        y = batch["y"].to(torch.float32)
        # the reference's jnp.maximum / jnp.abs gradients at a logit of
        # exactly 0: the max's tie splits 0.5 / 0.5, |x|'s slope is +1
        return torch.mean(torch.maximum(logit, torch.zeros_like(logit))
                          - logit * y
                          + torch.log1p(torch.exp(
                              -torch.where(logit >= 0, logit, -logit))))


@tapir.parallel_region
def _ncf_mlp_tower(h, mlp_params):
    # module-level for stable program-cache keys: the whole MLP tower is
    # one region, every relu folded into its GEMM's epilogue, replayed
    # without re-tracing
    for lp in mlp_params:
        h = tapir.linear(h, lp["w"], lp["b"], activation="relu")
    return h


def _xent(logits, labels):
    logits = logits.to(torch.float32)
    lse = torch.logsumexp(logits, dim=-1)
    gold = logits.gather(-1, labels.unsqueeze(-1).to(torch.int64))[..., 0]
    return torch.mean(lse - gold)


#: the four networks by the names the driver and the tests use
PAPER_NETS = {"cnn": lambda: PaperCNN(CNNConfig()),
              "lstm1": lambda: PaperLSTM(LSTM1),
              "lstm2": lambda: PaperLSTM(LSTM2),
              "ncf": lambda: PaperNCF(NCFConfig())}


def get_paper_net(name: str) -> _PaperNet:
    if name not in PAPER_NETS:
        raise ValueError(f"unknown paper net {name!r}; one of "
                         f"{sorted(PAPER_NETS)}")
    return PAPER_NETS[name]()
