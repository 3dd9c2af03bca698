"""Graph Convolutional Network over a reordered block-sparse adjacency.

The reference framework's target workload is sparse graphs / FEM matrices
(SURVEY §2.6 dataset box); the natural model family on top of its pipeline
is graph neural networks, where every layer is exactly our SpMM:

    H' = act( Â @ H @ W + b ),   Â = D^-1/2 (A + I) D^-1/2

Design: the graph is relabeled ONCE at construction with the similarity
reordering (symmetric row+col permutation, ≡ CSR::reorder2d csr.cpp:111-120)
so the adjacency densifies into 128-aligned blocks; Â is then stored in
Blocked-ELL with the NATURAL fixed partition (no further per-multiply
permutation), and every layer's Â @ H runs through the differentiable bell
SpMM (Triton-kernel forward on the GPU, XLA backward — gradients flow into H, so the
GCN trains end-to-end). Outputs are returned in the original node order.
"""
from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np

from ..formats.bell import bell_from_csr
from ..formats.csr import CSR
from ..ops.autodiff import bell_spmm
from ..ops.fine import DedupDevice, dedup_pair_from_csr, dedup_spmm_ad
from ..reorder.engine import BlockingEngine
from ..utils import get_permutation


def normalize_adjacency(adj: CSR) -> CSR:
    """Â = D^-1/2 (A + I) D^-1/2 (symmetric GCN normalization)."""
    S = adj.to_scipy().tolil(copy=True)
    S.setdiag(1.0)
    S = S.tocsr()
    deg = np.asarray(np.abs(S).sum(axis=1)).ravel()
    dinv = 1.0 / np.sqrt(np.maximum(deg, 1e-12))
    import scipy.sparse as sp

    D = sp.diags(dinv)
    return CSR.from_scipy(D @ S @ D)


@dataclasses.dataclass(frozen=True)
class GCNConfig:
    in_dim: int
    hidden_dim: int
    out_dim: int
    n_layers: int = 2
    block: int = 128
    tau: float = 0.3
    dtype: str = "float32"
    # "bell": reorder + Blocked-ELL (latent-block graphs, the default);
    # "fine": distinct-column dedup SpMM (ops/fine.py) — power-law graphs
    # where 128-blocking pads away all density; no reordering needed
    adjacency: str = "bell"


@dataclasses.dataclass(frozen=True)
class GCN:
    """Static structure: relabeled+blocked adjacency, node permutation."""

    cfg: GCNConfig
    n_nodes: int
    perm: np.ndarray          # original node id -> position used on device
    cols_idx: jax.Array | None       # [nbr, max_nb] adjacency block columns
    nb_row: jax.Array | None         # [nbr]
    adj_vals: jax.Array | None  # [nbr, max_nb, b, b] normalized adj blocks
    fine_fwd: DedupDevice | None = None   # adjacency="fine" packing
    fine_bwd: DedupDevice | None = None   # A_hat^T for the backward pass

    @classmethod
    def create(cls, adj: CSR, cfg: GCNConfig) -> "GCN":
        """adj: unweighted/weighted graph adjacency (CSR)."""
        ahat = normalize_adjacency(adj)
        dtype = jnp.bfloat16 if cfg.dtype == "bfloat16" else jnp.float32
        if cfg.adjacency == "fine":
            fwd, bwd = dedup_pair_from_csr(ahat, dtype=dtype)
            return cls(
                cfg=cfg,
                n_nodes=adj.rows,
                perm=np.arange(adj.rows),
                cols_idx=None, nb_row=None, adj_vals=None,
                fine_fwd=fwd, fine_bwd=bwd,
            )
        eng = BlockingEngine(
            tau=cfg.tau,
            row_block_size=cfg.block,
            col_block_size=cfg.block,
            force_fixed_size=True,
        )
        grouping = eng.get_grouping(ahat)
        perm = get_permutation(grouping)
        relabeled = ahat.reorder2d(grouping)
        bell = bell_from_csr(relabeled, None, block_row_size=cfg.block)
        return cls(
            cfg=cfg,
            n_nodes=adj.rows,
            perm=np.asarray(perm),
            cols_idx=jnp.asarray(bell.cols_idx),
            nb_row=jnp.asarray(bell.nb_row),
            adj_vals=jnp.asarray(bell.vals, dtype=dtype),
        )

    def _apply_fine(self, params, X: jax.Array) -> jax.Array:
        """Aggregation through the dedup kernel; features padded to the
        128-lane slab width (zero columns are exact no-ops)."""
        dtype = self.fine_fwd.W.dtype
        H = X.astype(dtype)
        nlayers = len(params["layers"])
        for i, lp in enumerate(params["layers"]):
            F = H.shape[1]
            Fp = -(-F // 128) * 128
            Hp = H if F == Fp else jnp.pad(H, ((0, 0), (0, Fp - F)))
            H = dedup_spmm_ad(self.fine_fwd, self.fine_bwd, Hp)[:, :F]
            H = H @ lp["w"].astype(dtype) + lp["b"].astype(dtype)
            if i < nlayers - 1:
                H = jax.nn.relu(H)
        return H.astype(jnp.float32)

    def _dims(self) -> list[tuple[int, int]]:
        cfg = self.cfg
        dims = [(cfg.in_dim, cfg.hidden_dim)]
        dims += [(cfg.hidden_dim, cfg.hidden_dim)] * (cfg.n_layers - 2)
        if cfg.n_layers > 1:
            dims.append((cfg.hidden_dim, cfg.out_dim))
        else:
            dims = [(cfg.in_dim, cfg.out_dim)]
        return dims

    def init(self, key) -> dict:
        layers = []
        for i, (din, dout) in enumerate(self._dims()):
            k = jax.random.fold_in(key, i)
            layers.append({
                "w": jax.random.normal(k, (din, dout), dtype=jnp.float32)
                / np.sqrt(din),
                "b": jnp.zeros((dout,), dtype=jnp.float32),
            })
        return {"layers": layers}

    def apply(self, params, X: jax.Array) -> jax.Array:
        """X [n_nodes, in_dim] -> logits [n_nodes, out_dim] (original order)."""
        if self.cfg.adjacency == "fine":
            return self._apply_fine(params, X)
        cfg = self.cfg
        dtype = self.adj_vals.dtype
        nbr, max_nb, bh, bw = self.adj_vals.shape
        # device node count (padded to block multiples; the relabeled
        # adjacency is square so nbr*bh == nbc*bw and H feeds back in)
        n_pad_rows = nbr * bh
        H = jnp.zeros((n_pad_rows, X.shape[1]), dtype=dtype)
        H = H.at[: self.n_nodes].set(X[self.perm].astype(dtype))
        nlayers = len(params["layers"])
        for i, lp in enumerate(params["layers"]):
            # aggregate: Â @ H  (rows/cols share the same block partition)
            H = bell_spmm(self.cols_idx, self.nb_row, self.adj_vals,
                          H)[:n_pad_rows]
            # transform
            H = H @ lp["w"].astype(dtype) + lp["b"].astype(dtype)
            if i < nlayers - 1:
                H = jax.nn.relu(H)
        out = H[: self.n_nodes].astype(jnp.float32)
        inv = np.argsort(self.perm)
        return out[jnp.asarray(inv)]


def make_gcn_train_step(model: GCN, optimizer):
    """Node-classification cross-entropy train step."""

    def loss_fn(params, X, labels, mask):
        logits = model.apply(params, X)
        logp = jax.nn.log_softmax(logits, axis=-1)
        nll = -jnp.take_along_axis(logp, labels[:, None], axis=1)[:, 0]
        return (nll * mask).sum() / jnp.maximum(mask.sum(), 1)

    @jax.jit
    def step(params, opt_state, X, labels, mask):
        loss, grads = jax.value_and_grad(loss_fn)(params, X, labels, mask)
        updates, opt_state = optimizer.update(grads, opt_state, params)
        params = jax.tree.map(lambda p, u: p + u, params, updates)
        return params, opt_state, loss

    return step


def make_sharded_gcn_apply(model: GCN, mesh):
    """Row-sharded GCN forward over a device mesh: adjacency block-rows and
    node activations sharded along the mesh axis; each layer all-gathers H
    (every chip's rows can reference any column block of A_hat), multiplies
    its resident block-rows locally, and keeps the output rows
    sharded. The dense feature transform stays local to the row shard.

    Returns ``apply(params, X) -> logits`` (original node order, replicated
    output). X is consumed replicated; pass n_devices-divisible padded
    shapes via the model's block padding (already guaranteed: nbr * block).
    """
    import jax
    from jax import shard_map
    from jax.sharding import NamedSharding, PartitionSpec as P

    axis = mesh.axis_names[0]
    n_dev = mesh.shape[axis]
    if model.adj_vals is None:
        raise ValueError(
            "make_sharded_gcn_apply needs a blocked adjacency; this GCN "
            "was built with adjacency='fine' (dedup devices). Shard it "
            "with parallel.shard_dedup_rowwise + dedup_spmm_rowsharded "
            "instead.")
    nbr, max_nb, bh, bw = model.adj_vals.shape
    if nbr % n_dev:
        raise ValueError(
            f"n_block_rows={nbr} not divisible by {n_dev} devices; rebuild "
            f"the GCN with block such that (padded rows / block) % devices == 0"
        )
    n_pad_rows = nbr * bh
    cfg = model.cfg
    dtype = model.adj_vals.dtype

    def local_layer(ci, nb, av, h_full, w, b):
        # ci/nb/av: this shard's block-rows; h_full: replicated [n_pad, F]
        out = bell_spmm(ci, nb, av, h_full)
        h = out @ w.astype(out.dtype) + b.astype(out.dtype)
        return h  # [n_pad/n_dev, F_out] row shard

    sharded_layer = shard_map(
        local_layer, mesh=mesh,
        in_specs=(P(axis, None), P(axis), P(axis, None, None, None),
                  P(None, None), P(None, None), P(None)),
        out_specs=P(axis, None),
    )

    sh = lambda *spec: NamedSharding(mesh, P(*spec))
    ci = jax.device_put(model.cols_idx, sh(axis, None))
    nb = jax.device_put(model.nb_row, sh(axis))
    av = jax.device_put(model.adj_vals, sh(axis, None, None, None))
    inv = np.argsort(model.perm)

    @jax.jit
    def apply(params, X):
        H = jnp.zeros((n_pad_rows, X.shape[1]), dtype=dtype)
        H = H.at[: model.n_nodes].set(X[jnp.asarray(model.perm)].astype(dtype))
        nlayers = len(params["layers"])
        for i, lp in enumerate(params["layers"]):
            # all-gather the row shard back to replicated for the next
            # aggregation (A_hat columns span every shard)
            H = sharded_layer(ci, nb, av, H, lp["w"], lp["b"])
            H = jax.lax.with_sharding_constraint(H, sh(None, None))
            if i < nlayers - 1:
                H = jax.nn.relu(H)
        out = H[: model.n_nodes].astype(jnp.float32)
        return out[jnp.asarray(inv)]

    return apply
