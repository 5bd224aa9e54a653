"""Actor-critic policies over the memory cores (counterpart of
gcm_tpu/rl/wrappers.py): a config-dict driven wrapper with a Linear
preprocessor (and an optional user MLP, optionally frozen), an optional
one-hot of the previous action beside the observation, the memory core,
and logit and value heads with rllib's normc(0.01) initialisation.

`GCMActorCritic` runs the ring core (RingDenseGCM, the default), the dense
one (DenseGCM) or a fast core: "banded" (BandedRingGCM, a deterministic
TemporalBackedge), "clique" (CliqueGCM, DenseEdge) or "banded_scored"
(BandedScoredGCM, a windowed Distance, alone or after forward temporal
hops); "auto" picks among them by the selector's structure, as JAX's rule
does: each family's fast core beat "dense" in an RL update on the card
(chip_smoke.py's policy line). `SparseGCMActorCritic` runs
SparseGCM over a whole window in one call, or with mesh= the node-sharded
core (parallel/sharded_sparse.py::ShardedSparseGCM) over the mesh axis
mesh_axis, in its plain selector configuration only, as JAX's.

The whole-trajectory call takes the core's scan-free `window()` where the
core has one, no noise or generator is given, its direction is forward,
its `window_profitable` gate (card-measured, by mode: train=True under a
backward) and its `window_applicable` check (dones, structure) agree;
else its scan with the caller's remat. No gate of the JAX package's
config is copied. `train_remat_for` holds the training replay's remat
measured on the card (chip_smoke.py's RL and reverse phases).
"""

from __future__ import annotations

import torch
from torch import nn
from torch.func import functional_call

from gcm_tpu_torch.device import resolve_device
from gcm_tpu_torch.edges.chain import EdgeChain
from gcm_tpu_torch.edges.dense import DenseEdge
from gcm_tpu_torch.edges.distance import Distance
from gcm_tpu_torch.edges.sparse_learned import LearnedEdge as \
    SparseLearnedEdge
from gcm_tpu_torch.edges.sparse_temporal import TemporalEdge
from gcm_tpu_torch.edges.temporal import TemporalBackedge
from gcm_tpu_torch.models.banded_gcm import BandedRingGCM, BandedScoredGCM
from gcm_tpu_torch.models.clique_gcm import CliqueGCM
from gcm_tpu_torch.models.dense_gcm import DenseGCM
from gcm_tpu_torch.models.dense_reversible import dense_reversible_supported
from gcm_tpu_torch.models.positional import (PositionalEncoding,
                                             RelativePositionalEncoding)
from gcm_tpu_torch.models.ring_gcm import RingDenseGCM
from gcm_tpu_torch.models.ring_reversible import reversible_supported
from gcm_tpu_torch.models.sparse_gcm import SparseGCM
from gcm_tpu_torch.nn.dense_conv import (DenseGNN, DenseGraphConv,
                                         plan_conv_stack)
from gcm_tpu_torch.nn.module import MLP, Linear
from gcm_tpu_torch.nn.sparse_conv import GraphConv, SparseGNN
from gcm_tpu_torch.parallel.sharded_sparse import ShardedSparseGCM

DENSE_DEFAULT_CONFIG = {
    # "ring" (RingDenseGCM, the default), "dense" (DenseGCM), "banded"
    # (BandedRingGCM), "clique" (CliqueGCM), "banded_scored"
    # (BandedScoredGCM) or "auto" (the fast core the selector's structure
    # supports, where it won on the card, else "dense")
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
    # what core='auto' serves: 'rl' (collection steps + training replay),
    # 'inference' (stepwise forward) or 'trajectory_train' (whole-
    # trajectory window training); only the windowed-distance family
    # depends on it, as in the JAX package
    "usage": "rl",
}

SPARSE_DEFAULT_CONFIG = {
    **DENSE_DEFAULT_CONFIG,
    "mesh": None,  # a DeviceMesh: the node-sharded sparse core
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

# Whether a training replay takes the reversible backward (remat="reverse")
# where the call allows it, from chip_smoke.py's reverse phase: a CartPole
# replay and its backward at the RL phase's shapes, timed in turns against
# remat=False on each core (PERF.md §6); reverse lost about 2x on both, and
# the phase fails where a reading disagrees with these constants.
RING_REVERSE_BWD = False
DENSE_REVERSE_BWD = False


def train_remat_for(core, T: int, dones=None):
    """The remat a training replay of T steps passes to the core's scan:
    "reverse" where the card measured the reversible backward faster
    (RING_REVERSE_BWD / DENSE_REVERSE_BWD) and the call allows it (no
    dones, no edge weights, a fused dense step); else, on the ring core,
    chunks of the largest divisor K of T up to TRAIN_REMAT_CHUNK where
    2 <= K < T (chunking needs two chunks or more), else False. The
    forward is the same for every choice."""
    if isinstance(core, DenseGCM):
        return ("reverse" if DENSE_REVERSE_BWD
                and dense_reversible_supported(core, dones) else False)
    if not isinstance(core, RingDenseGCM):
        return False
    if RING_REVERSE_BWD and reversible_supported(core, dones):
        return "reverse"
    if TRAIN_REMAT_CHUNK is None:
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

    def _resolve_auto_core(self) -> str:
        """core='auto': the fast core the selector's structure supports,
        under JAX's rule (any aux selector, positional encoding, pooling,
        edge weights or a custom GNN off the fast cores' conv pattern
        takes "dense"; a deterministic TemporalBackedge "banded"; DenseEdge
        "clique"; a forward windowed Distance, alone or after forward
        temporal hops, "banded_scored" under usage='trajectory_train').
        On the card each family's fast core beat "dense" at graph sizes 32
        and 256 (chip_smoke.py's policy line: an A2C update, or for the
        scored core a trajectory step; PERF.md §6); a family that
        ever loses there needs its own rule."""
        cfg = self.cfg
        if not self._plain_config():
            return "dense"
        gnn = cfg["gnn"]
        if gnn is not None and not (isinstance(gnn, DenseGNN) and
                                    plan_conv_stack(
                                        gnn.layers,
                                        allowed_aggrs=("add", "mean"))):
            return "dense"
        sel = cfg["edge_selectors"]
        if isinstance(sel, TemporalBackedge) and not sel.learned:
            return "banded"
        if isinstance(sel, DenseEdge):
            return "clique"
        dist = None
        if isinstance(sel, Distance):
            dist = sel
        elif (isinstance(sel, EdgeChain) and len(sel.selectors) == 2
              and isinstance(sel.selectors[0], TemporalBackedge)
              and not sel.selectors[0].learned
              and sel.selectors[0].direction == "forward"
              and isinstance(sel.selectors[1], Distance)):
            dist = sel.selectors[1]
        if (dist is not None and dist.window is not None
                and not dist.bidirectional
                and cfg["usage"] == "trajectory_train"):
            return "banded_scored"
        return "dense"

    def _plain_config(self) -> bool:
        """No aux selector, positional encoding, pooling or edge weights:
        the only configuration the fast cores take."""
        cfg = self.cfg
        return not (cfg["aux_edge_selectors"] or cfg["positional_encoding"]
                    or cfg["pooled"] or cfg["edge_weights"])

    def _fast_core(self, generator):
        """BandedScoredGCM, CliqueGCM or BandedRingGCM from the config, or
        None for the ring and dense cores."""
        cfg = self.cfg
        core, sel = cfg["core"], cfg["edge_selectors"]
        if core not in ("banded_scored", "clique", "banded"):
            return None
        if core == "banded_scored":
            hops = ()
            if isinstance(sel, EdgeChain):
                if not (len(sel.selectors) == 2
                        and isinstance(sel.selectors[0], TemporalBackedge)
                        and isinstance(sel.selectors[1], Distance)):
                    raise ValueError(
                        "core='banded_scored' accepts a Distance selector "
                        "or an EdgeChain([TemporalBackedge, Distance])")
                hops = tuple(sel.selectors[0].hops)
                sel = sel.selectors[1]
            elif not isinstance(sel, Distance):
                raise ValueError(
                    "core='banded_scored' needs a Distance edge selector "
                    "(with window=), got " + type(sel).__name__)
        elif core == "clique":
            if sel is not None and not isinstance(sel, DenseEdge):
                raise ValueError(
                    "core='clique' implements the DenseEdge (fully-"
                    "connected-past) graph: pass edge_selectors=DenseEdge() "
                    "or None")
        elif not (isinstance(sel, TemporalBackedge) and not sel.learned):
            raise ValueError("core='banded' needs a deterministic "
                             "TemporalBackedge selector")
        if not self._plain_config():
            raise ValueError(f"core={core!r} supports only its plain "
                             f"selector configuration (no aux selectors, "
                             f"positional encoding, pooling or edge "
                             f"weights)")
        kw = dict(preprocessor=_build_preprocessor(
            self.input_dim, cfg, self.device, generator),
            graph_size=cfg["graph_size"], device=self.device)
        gnn = self._gnn(generator)
        if core == "banded_scored":
            return BandedScoredGCM(gnn, distance=sel, hops=hops, **kw)
        if core == "clique":
            return CliqueGCM(gnn, **kw)
        return BandedRingGCM(gnn, hops=sel.hops, direction=sel.direction,
                             **kw)

    def _build_core(self, generator):
        cfg = self.cfg
        if cfg["core"] == "auto":
            cfg["core"] = self._resolve_auto_core()
        if cfg["core"] not in ("ring", "dense", "banded", "clique",
                               "banded_scored"):
            raise ValueError(f"unknown core {cfg['core']!r}")
        pe = self._positional()
        fast = self._fast_core(generator)
        if fast is not None:
            return fast
        core_cls = RingDenseGCM if cfg["core"] == "ring" else DenseGCM
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

    def _noise_kw(self, generator, noise) -> dict:
        """The noise arguments for the core: none for the fast cores,
        which are deterministic and draw none (JAX's drop their key)."""
        if (generator is None and noise is None) or not hasattr(
                self.core, "step_noise"):
            return {}
        return dict(generator=generator, noise=noise)

    def step(self, obs, state, prev_action=None,
             generator: torch.Generator | None = None, noise=None):
        """One timestep: obs [B, obs_dim] -> (logits [B, A], value [B],
        state)."""
        x = self._concat_prev_action(obs, prev_action)
        belief, state = self.core(x, state,
                                  **self._noise_kw(generator, noise))
        return (*self._heads(belief), state)

    def uses_window(self, dones=None, train: bool = False,
                    generator=None, noise=None) -> bool:
        """Whether the whole-trajectory call takes the core's window():
        a core with one, no noise or generator, a forward direction, its
        card-measured gate for the mode and its structural check."""
        core = self.core
        return (generator is None and noise is None
                and hasattr(core, "window")
                and getattr(core, "direction", "forward") == "forward"
                and core.window_profitable(
                    mode="train" if train else "forward")
                and (not hasattr(core, "window_applicable")
                     or core.window_applicable(dones=dones)))

    def forward(self, obs_seq, state, prev_actions=None, dones=None,
                remat=False, generator: torch.Generator | None = None,
                noise=None, train: bool = False):
        """Whole trajectory: obs_seq [B, T, obs_dim] -> (logits [B, T, A],
        values [B, T], state). dones [B, T] reset the memory of ended
        episodes, as collection did. The core's window() where
        `uses_window` says so (train=True: the call sits under a
        backward), else its scan with `remat`."""
        x = self._concat_prev_action(obs_seq, prev_actions)
        if self.uses_window(dones, train, generator, noise):
            beliefs, state = self.core.window(x, state, dones=dones)
        else:
            beliefs, state = self.core.scan(
                x, state, dones=dones, remat=remat,
                **self._noise_kw(generator, noise))
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
            if (cfg["aux_edge_selectors"] or cfg["positional_encoding"]
                    or cfg["max_hops"] or cfg["pooled"] or cfg["edge_weights"]
                    or cfg["aggregation"] == "slots"):
                raise ValueError(
                    "mesh= (the node-sharded core) supports only the plain "
                    "selector configuration: no aux selectors, positional "
                    "encoding, max_hops, pooling, edge weights or slots")
            return ShardedSparseGCM(
                self._gnn(generator).layers, cfg["mesh"],
                axis=cfg["mesh_axis"],
                preprocessor=_build_preprocessor(self.input_dim, cfg,
                                                 self.device, generator),
                edge_selectors=cfg["edge_selectors"],
                graph_size=cfg["graph_size"], max_edges=cfg["max_edges"],
                device=self.device)
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
                generator: torch.Generator | None = None, noise=None,
                train: bool = False):
        """dones [B, T] keep edges and positions within episodes in the one
        whole-window call; remat and train are accepted for the trainers'
        signature and change nothing (no per-step scan)."""
        del remat, train
        B, T, _ = obs_seq.shape
        x = self._concat_prev_action(obs_seq, prev_actions)
        if taus is None:
            taus = torch.full((B,), T, dtype=torch.int32, device=x.device)
        beliefs, state = self.core(x, taus, state, dones=dones,
                                   generator=generator, noise=noise)
        return (*self._heads(beliefs), state)
