"""Minibatch GCN: layer-wise BLOCK-neighbor sampling.

For graphs whose Blocked-ELL exceeds HBM, full-graph aggregation is
impossible; the standard answer is neighbor sampling (GraphSAGE).  The
The twist here: sample at BLOCK granularity, not node granularity —

- a minibatch is a set of seed block-rows;
- per layer, each block-row keeps at most ``fanout`` of its nonzero
  adjacency blocks (sampled without replacement, rescaled by total/kept so
  aggregation stays an unbiased estimator);
- every per-layer sub-problem has STATIC shapes: the layer-k block set is
  padded to cap_k = batch_blocks * fanout^(L-k) (clipped at the graph's
  total block-rows), so ONE jit trace serves every resample — indices and
  values change, shapes don't.  Dummy rows have zero block count and their
  output rows are never referenced by the next layer's (real-only) column
  relabeling.

Device memory per step is bounded by the caps regardless of graph size.
Each layer's aggregation is the same differentiable bell SpMM as the
full-graph model, so minibatch training flows gradients identically.
"""
from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np

from ..ops.autodiff import bell_spmm
from .gcn import GCN


@jax.tree_util.register_pytree_node_class
@dataclasses.dataclass(frozen=True)
class LayerBatch:
    """One layer's sampled sub-adjacency (static shapes).

    Rows are the layer's (padded) output block set; ``cols_idx`` holds
    positions into the PREVIOUS layer's (padded) block set."""

    cols_idx: jax.Array   # int32 [cap_out, fanout], -1 pad, front-compacted
    nb_row: jax.Array     # int32 [cap_out]
    vals: jax.Array       # [cap_out, fanout, b, b] rescaled adjacency blocks

    def tree_flatten(self):
        return (self.cols_idx, self.nb_row, self.vals), None

    @classmethod
    def tree_unflatten(cls, aux, children):
        return cls(*children)


@jax.tree_util.register_pytree_node_class
@dataclasses.dataclass(frozen=True)
class MiniBatch:
    layers: tuple           # LayerBatch per GCN layer, input-to-output order
    in_blocks: jax.Array    # int32 [cap_0] global ids of the innermost set
    seed_blocks: np.ndarray  # global block-row ids of the batch (unpadded)

    def tree_flatten(self):
        # seed_blocks rides as a LEAF, not aux_data: aux participates in the
        # treedef, so distinct seed sets would give every batch a distinct
        # treedef and the jitted train step would retrace per batch —
        # defeating the module's static-shape design. As a leaf it only
        # fixes the SHAPE (batch size), which is what must stay constant.
        return (self.layers, self.in_blocks, self.seed_blocks), None

    @classmethod
    def tree_unflatten(cls, aux, children):
        return cls(layers=children[0], in_blocks=children[1],
                   seed_blocks=children[2])


class BlockSampler:
    """Host-side layer-wise block-neighbor sampler over a GCN's blocked
    adjacency.  Emitted shapes depend only on (batch_blocks, fanout,
    n_layers) — resampling is retrace-free."""

    def __init__(self, model: GCN, fanout: int, seed: int = 0):
        self.model = model
        self.fanout = int(fanout)
        self.rng = np.random.default_rng(seed)
        self.cols = np.asarray(model.cols_idx)
        self.nb = np.asarray(model.nb_row)
        self.vals = np.asarray(model.adj_vals, dtype=np.float32)
        self.nbr = self.cols.shape[0]
        self.b = model.adj_vals.shape[2]

    def caps(self, batch_blocks: int, n_layers: int) -> list[int]:
        """Static padded block-set size per level, output (seeds) last."""
        caps = [batch_blocks]
        for _ in range(n_layers):
            caps.append(min(caps[-1] * self.fanout, self.nbr))
        return caps[::-1]  # innermost first

    def sample(self, seed_blocks, n_layers: int) -> MiniBatch:
        seed_blocks = np.asarray(seed_blocks, dtype=np.int64)
        caps = self.caps(seed_blocks.size, n_layers)  # len n_layers+1
        f, b = self.fanout, self.b

        # pad the seed set to its static cap with -1 dummy rows
        def pad_set(ids, cap):
            out = np.full(cap, -1, dtype=np.int64)
            out[: ids.size] = ids
            return out

        level_sets = [None] * (n_layers + 1)
        level_sets[n_layers] = pad_set(seed_blocks, caps[n_layers])

        raw = []  # per layer k (output level k+... ): sampled global cols
        rows = level_sets[n_layers]
        for k in range(n_layers, 0, -1):
            cap_out = caps[k]
            sel_cols = np.full((cap_out, f), -1, dtype=np.int64)
            sel_vals = np.zeros((cap_out, f, b, b), dtype=np.float32)
            for t, r in enumerate(rows):
                if r < 0:
                    continue
                n = int(self.nb[r])
                if n == 0:
                    continue
                if n <= f:
                    keep = np.arange(n)
                    scale = 1.0
                else:
                    keep = self.rng.choice(n, size=f, replace=False)
                    scale = n / f  # unbiased aggregation estimate
                sel_cols[t, : keep.size] = self.cols[r, keep]
                sel_vals[t, : keep.size] = self.vals[r, keep] * scale
            uniq = np.unique(sel_cols[sel_cols >= 0])
            level_sets[k - 1] = pad_set(uniq, caps[k - 1])
            raw.append((sel_cols, sel_vals))
            rows = level_sets[k - 1]

        # relabel each layer's global cols to positions in its input set
        layers = []
        for k, (sel_cols, sel_vals) in zip(range(n_layers, 0, -1), raw):
            in_set = level_sets[k - 1]
            local = np.full(self.nbr, -1, dtype=np.int64)
            real = in_set[in_set >= 0]
            local[real] = np.flatnonzero(in_set >= 0)
            loc_cols = np.where(
                sel_cols >= 0, local[np.maximum(sel_cols, 0)], -1)
            nb_row = (loc_cols >= 0).sum(axis=1).astype(np.int32)
            order = np.argsort(loc_cols < 0, axis=1, kind="stable")
            loc_cols = np.take_along_axis(loc_cols, order, axis=1)
            sel_vals = np.take_along_axis(
                sel_vals, order[:, :, None, None], axis=1)
            layers.append(LayerBatch(
                cols_idx=jnp.asarray(loc_cols, dtype=jnp.int32),
                nb_row=jnp.asarray(nb_row),
                vals=jnp.asarray(sel_vals, dtype=self.model.adj_vals.dtype),
            ))
        layers.reverse()  # input-to-output order

        in0 = level_sets[0]
        return MiniBatch(
            layers=tuple(layers),
            in_blocks=jnp.asarray(np.maximum(in0, 0), dtype=jnp.int32),
            seed_blocks=seed_blocks,
        )


def features_to_blocks(model: GCN, X: jax.Array) -> jax.Array:
    """Permute node features into the model's device order and reshape to
    [nbr, b, in_dim] for block gathering."""
    nbr, _, b, _ = model.adj_vals.shape
    H = jnp.zeros((nbr * b, X.shape[1]), dtype=X.dtype)
    H = H.at[: model.n_nodes].set(X[jnp.asarray(model.perm)])
    return H.reshape(nbr, b, X.shape[1])


def apply_minibatch(model: GCN, params, X_blocks: jax.Array,
                    batch: MiniBatch) -> jax.Array:
    """Forward over a sampled minibatch.

    ``X_blocks``: output of ``features_to_blocks``.  Returns logits for the
    seed blocks' node rows: [cap_seed * b, out_dim] in the PERMUTED block
    order of ``batch.seed_blocks`` (first ``len(seed_blocks) * b`` rows are
    the real nodes)."""
    dtype = model.adj_vals.dtype
    H = X_blocks[batch.in_blocks].reshape(-1, X_blocks.shape[2]).astype(dtype)
    nlayers = len(params["layers"])
    for i, (lb, lp) in enumerate(zip(batch.layers, params["layers"])):
        H = bell_spmm(lb.cols_idx, lb.nb_row, lb.vals, H)
        H = H @ lp["w"].astype(dtype) + lp["b"].astype(dtype)
        if i < nlayers - 1:
            H = jax.nn.relu(H)
    return H.astype(jnp.float32)


def make_minibatch_train_step(model: GCN, optimizer):
    """Cross-entropy train step over seed-block nodes (static shapes: one
    trace serves every resampled batch)."""

    def loss_fn(params, X_blocks, batch, labels_blk, mask_blk):
        logits = apply_minibatch(model, params, X_blocks, batch)
        logp = jax.nn.log_softmax(logits, axis=-1)
        nll = -jnp.take_along_axis(logp, labels_blk[:, None], axis=1)[:, 0]
        return (nll * mask_blk).sum() / jnp.maximum(mask_blk.sum(), 1)

    @jax.jit
    def step(params, opt_state, X_blocks, batch, labels_blk, mask_blk):
        loss, grads = jax.value_and_grad(loss_fn)(
            params, X_blocks, batch, labels_blk, mask_blk)
        updates, opt_state = optimizer.update(grads, opt_state, params)
        params = jax.tree.map(lambda p, u: p + u, params, updates)
        return params, opt_state, loss

    return step


def seed_labels(model: GCN, labels: np.ndarray, mask: np.ndarray,
                batch: MiniBatch):
    """Gather per-node labels/mask for a batch's seed rows (host side)."""
    b = model.adj_vals.shape[2]
    nbr = model.adj_vals.shape[0]
    lab_pad = np.zeros(nbr * b, dtype=np.int64)
    msk_pad = np.zeros(nbr * b, dtype=np.float32)
    lab_pad[: model.n_nodes] = labels[model.perm]
    msk_pad[: model.n_nodes] = mask[model.perm]
    cap = batch.layers[-1].nb_row.shape[0]
    seeds = np.full(cap, -1, dtype=np.int64)
    seeds[: batch.seed_blocks.size] = batch.seed_blocks
    rows = (np.maximum(seeds, 0)[:, None] * b + np.arange(b)).reshape(-1)
    lab = lab_pad[rows]
    msk = np.where(np.repeat(seeds, b) >= 0, msk_pad[rows], 0.0)
    return jnp.asarray(lab), jnp.asarray(msk.astype(np.float32))
