"""Actor-critic policies over the memory cores (counterpart of
gcm_tpu/rl/wrappers.py): a config-dict driven wrapper with a Linear
preprocessor (and an optional user MLP, optionally frozen), an optional
one-hot of the previous action beside the observation, the memory core,
and logit and value heads with rllib's normc(0.01) initialisation.

`GCMActorCritic` runs the ring core (RingDenseGCM, the default) or the
dense one (DenseGCM) step by step; `SparseGCMActorCritic` runs SparseGCM
over a whole window in one call. The JAX package's core="auto", "banded",
"clique" and "banded_scored" are the fast cores of ROADMAP Queue 1 item 7,
and mesh= (the sharded sparse core) is item 9: both raise until then.

The JAX wrapper also dispatches a whole-trajectory call to the ring core's
scan-free window() above graph sizes measured on a TPU; the port always
scans (window() waits for item 7), which gives the same outputs. No gate of
the JAX package's config is copied. `train_remat_for` holds the training
replay's remat choice measured on the card (chip_smoke.py's RL phase).
"""

from __future__ import annotations

import torch
from torch import nn
from torch.func import functional_call

from gcm_tpu_torch.device import resolve_device
from gcm_tpu_torch.edges.sparse_learned import LearnedEdge as \
    SparseLearnedEdge
from gcm_tpu_torch.edges.sparse_temporal import TemporalEdge
from gcm_tpu_torch.models.dense_gcm import DenseGCM
from gcm_tpu_torch.models.positional import (PositionalEncoding,
                                             RelativePositionalEncoding)
from gcm_tpu_torch.models.ring_gcm import FAST_CORES, RingDenseGCM
from gcm_tpu_torch.models.sparse_gcm import SparseGCM
from gcm_tpu_torch.nn.dense_conv import DenseGNN, DenseGraphConv
from gcm_tpu_torch.nn.module import MLP, Linear
from gcm_tpu_torch.nn.sparse_conv import GraphConv, SparseGNN

PARALLELISM = "ROADMAP Queue 1 item 9 (parallelism)"

DENSE_DEFAULT_CONFIG = {
    # "ring" (RingDenseGCM, the default) or "dense" (DenseGCM); the JAX
    # package's "auto", "banded", "clique" and "banded_scored" wait for
    # the fast cores
    "core": "ring",
    "graph_size": 32,
    "gnn_input_size": 64,
    "gnn_output_size": 64,
    "gnn": None,  # None: two DenseGraphConv + tanh layers of these sizes
    "edge_selectors": None,
    "aux_edge_selectors": None,
    "pooled": False,
    "edge_weights": False,
    "preprocessor": None,
    "preprocessor_frozen": False,
    "use_prev_action": False,
    # None | 'add' | 'cat' | 'relative' (the dense core only)
    "positional_encoding": None,
    "positional_encoding_dim": 4,
    # how the JAX package's core='auto' weighs its TPU crossovers; kept as
    # a key so that configs carry over
    "usage": "rl",
}

SPARSE_DEFAULT_CONFIG = {
    **DENSE_DEFAULT_CONFIG,
    "mesh": None,  # the sharded sparse core: waits for parallelism
    "mesh_axis": "dp",
    "max_edges": 512,
    "max_hops": None,
    "hop_cap": None,
    # "auto" (spmm_edge_list) | "slots" (spmm_slots, k sink slots); slot_k
    # None derives k from the selector (TemporalEdge: len(hops), the sparse
    # LearnedEdge: num_edge_samples)
    "aggregation": "auto",
    "slot_k": None,
    "emit": "auto",
}

# The training replay's remat on the ring core, measured on the card:
# chip_smoke.py's RL phase times a CartPole replay and its backward with
# remat=False and with chunks of 16 and 8 steps, in turns, and remat=False
# won by about 2x (PERF.md). None keeps remat=False; an int K would
# checkpoint chunks of K steps.
TRAIN_REMAT_CHUNK: int | None = None


def train_remat_for(core, T: int):
    """The remat a training replay of T steps passes to the core's scan:
    on the ring core chunks of the largest divisor K of T up to
    TRAIN_REMAT_CHUNK where 2 <= K < T (chunking needs two chunks or
    more), else False. The forward is the same for every choice."""
    if not isinstance(core, RingDenseGCM) or TRAIN_REMAT_CHUNK is None:
        return False
    K = min(TRAIN_REMAT_CHUNK, T)
    while K > 1 and T % K:
        K -= 1
    return K if 2 <= K < T else False


class _FrozenMLP(nn.Module):
    """Runs `inner` on detached copies of its parameters: no gradient
    reaches them (preprocessor_frozen; JAX's stop_gradient)."""

    def __init__(self, inner):
        super().__init__()
        self.inner = inner

    def forward(self, x):
        frozen = {n: p.detach() for n, p in self.inner.named_parameters()}
        return functional_call(self.inner, frozen, (x,))


def _derive_slot_k(sel):
    """The per-(sink, source window) degree bound a selector guarantees:
    TemporalEdge's len(hops), the sparse LearnedEdge's num_edge_samples;
    None for any other."""
    if isinstance(sel, TemporalEdge):
        return len(sel.hops)
    if isinstance(sel, SparseLearnedEdge):
        return sel.num_edge_samples
    return None


def _build_preprocessor(input_dim, cfg, device, generator):
    pp = Linear(input_dim, cfg["gnn_input_size"], device=device,
                generator=generator)
    user = cfg["preprocessor"]
    if user is None:
        return MLP([pp])
    if cfg["preprocessor_frozen"]:
        user = _FrozenMLP(user)
    return MLP([pp, user])


class GCMActorCritic(nn.Module):
    """Dense-core actor-critic. Weights come from `generator` (torch's
    global generator where None), the heads normc(0.01)."""

    CONFIG = DENSE_DEFAULT_CONFIG

    def __init__(self, obs_dim: int, num_actions: int, num_outputs: int, *,
                 device=None, generator: torch.Generator | None = None,
                 **cfg):
        super().__init__()
        for k in cfg:
            if k not in self.CONFIG:
                raise ValueError(f"Invalid config key {k}")
        self.device = resolve_device(device)
        self.cfg = dict(self.CONFIG, **cfg)
        self.obs_dim = obs_dim
        self.num_actions = num_actions
        self.num_outputs = num_outputs
        self.input_dim = obs_dim + (num_actions if self.cfg["use_prev_action"]
                                    else 0)
        self.core = self._build_core(generator)
        h = self.cfg["gnn_output_size"]
        self.logit_branch = Linear(h, num_outputs, init=("normc", 0.01),
                                   device=self.device, generator=generator)
        self.value_branch = Linear(h, 1, init=("normc", 0.01),
                                   device=self.device, generator=generator)

    def _gnn(self, generator):
        if self.cfg["gnn"] is not None:
            return self.cfg["gnn"]
        gi, go = self.cfg["gnn_input_size"], self.cfg["gnn_output_size"]
        kw = dict(device=self.device, generator=generator)
        return DenseGNN([DenseGraphConv(gi, go, **kw), torch.tanh,
                         DenseGraphConv(go, go, **kw), torch.tanh],
                        use_weights=self.cfg["edge_weights"])

    def _positional(self):
        cfg = self.cfg
        mode = cfg["positional_encoding"]
        if not mode:
            return None
        if mode == "relative":
            if cfg["core"] != "dense":
                raise ValueError("positional_encoding='relative' rolls the "
                                 "table by logical position: the dense core "
                                 "only")
            return RelativePositionalEncoding(
                max_len=cfg["graph_size"], feat_dim=cfg["gnn_input_size"],
                device=self.device)
        return PositionalEncoding(
            max_len=cfg["graph_size"], mode=mode,
            cat_dim=cfg["positional_encoding_dim"],
            feat_dim=cfg["gnn_input_size"], device=self.device)

    def _build_core(self, generator):
        cfg = self.cfg
        if cfg["core"] in ("auto", "banded", "clique", "banded_scored"):
            raise NotImplementedError(
                f"core={cfg['core']!r} waits for {FAST_CORES}")
        if cfg["core"] not in ("ring", "dense"):
            raise ValueError(f"unknown core {cfg['core']!r}")
        core_cls = RingDenseGCM if cfg["core"] == "ring" else DenseGCM
        pe = self._positional()
        return core_cls(
            gnn=self._gnn(generator),
            preprocessor=_build_preprocessor(self.input_dim, cfg,
                                             self.device, generator),
            edge_selectors=cfg["edge_selectors"],
            aux_edge_selectors=cfg["aux_edge_selectors"],
            graph_size=cfg["graph_size"], pooled=cfg["pooled"],
            positional_encoder=pe, edge_weights=cfg["edge_weights"],
            device=self.device)

    def initial_state(self, B: int, dtype=torch.float32):
        return self.core.initial_state(B, self.input_dim, dtype=dtype)

    def _concat_prev_action(self, obs, prev_actions):
        if not self.cfg["use_prev_action"]:
            return obs
        if prev_actions is None:
            prev_actions = torch.zeros(obs.shape[:-1], dtype=torch.int64,
                                       device=obs.device)
        onehot = torch.nn.functional.one_hot(prev_actions.long(),
                                             self.num_actions)
        return torch.cat([obs, onehot.to(obs.dtype)], dim=-1)

    def _heads(self, belief):
        return self.logit_branch(belief), self.value_branch(belief)[..., 0]

    def step(self, obs, state, prev_action=None,
             generator: torch.Generator | None = None, noise=None):
        """One timestep: obs [B, obs_dim] -> (logits [B, A], value [B],
        state)."""
        x = self._concat_prev_action(obs, prev_action)
        belief, state = self.core(x, state, generator=generator, noise=noise)
        return (*self._heads(belief), state)

    def forward(self, obs_seq, state, prev_actions=None, dones=None,
                remat=False, generator: torch.Generator | None = None,
                noise=None):
        """Whole trajectory: obs_seq [B, T, obs_dim] -> (logits [B, T, A],
        values [B, T], state). dones [B, T] reset the memory of ended
        episodes inside the scan, as collection did; remat goes to the
        core's scan."""
        x = self._concat_prev_action(obs_seq, prev_actions)
        beliefs, state = self.core.scan(x, state, dones=dones, remat=remat,
                                        generator=generator, noise=noise)
        return (*self._heads(beliefs), state)


class SparseGCMActorCritic(GCMActorCritic):
    """Sparse-core actor-critic: a whole window in one time-batched
    SparseGCM call."""

    CONFIG = SPARSE_DEFAULT_CONFIG

    def _gnn(self, generator):
        if self.cfg["gnn"] is not None:
            return self.cfg["gnn"]
        gi, go = self.cfg["gnn_input_size"], self.cfg["gnn_output_size"]
        kw = dict(device=self.device, generator=generator)
        return SparseGNN([GraphConv(gi, go, **kw), torch.tanh,
                          GraphConv(go, go, **kw), torch.tanh])

    def _build_core(self, generator):
        cfg = self.cfg
        if cfg["mesh"] is not None:
            raise NotImplementedError(f"mesh= (the sharded sparse core) "
                                      f"waits for {PARALLELISM}")
        slot_k = cfg["slot_k"]
        if cfg["aggregation"] == "slots" and slot_k is None:
            # aux selectors add edges to the same sinks, so a bound from
            # the primary selector alone would under-count
            if cfg["aux_edge_selectors"] is None:
                slot_k = _derive_slot_k(cfg["edge_selectors"])
            if slot_k is None:
                raise ValueError("aggregation='slots': slot_k could not be "
                                 "derived from the edge selector; pass "
                                 "slot_k")
        return SparseGCM(
            gnn=self._gnn(generator),
            preprocessor=_build_preprocessor(self.input_dim, cfg,
                                             self.device, generator),
            edge_selectors=cfg["edge_selectors"],
            aux_edge_selectors=cfg["aux_edge_selectors"],
            graph_size=cfg["graph_size"], max_edges=cfg["max_edges"],
            max_hops=cfg["max_hops"], hop_cap=cfg["hop_cap"],
            positional_encoder=self._positional(),
            aggregation=cfg["aggregation"], slot_k=slot_k, emit=cfg["emit"],
            device=self.device)

    def step(self, obs, state, prev_action=None,
             generator: torch.Generator | None = None, noise=None):
        logits, values, state = self(
            obs[:, None, :], state,
            None if prev_action is None else prev_action[:, None],
            generator=generator, noise=noise)
        return logits[:, 0], values[:, 0], state

    def forward(self, obs_seq, state, prev_actions=None, taus=None,
                dones=None, remat=False,
                generator: torch.Generator | None = None, noise=None):
        """dones [B, T] keep edges and positions within episodes in the one
        whole-window call; remat is accepted for the trainers' signature
        and changes nothing (no per-step scan)."""
        del remat
        B, T, _ = obs_seq.shape
        x = self._concat_prev_action(obs_seq, prev_actions)
        if taus is None:
            taus = torch.full((B,), T, dtype=torch.int32, device=x.device)
        beliefs, state = self.core(x, taus, state, dones=dones,
                                   generator=generator, noise=noise)
        return (*self._heads(beliefs), state)
