"""Block-sparse Mixture-of-Experts FFN with expert parallelism.

Each expert is a Blocked-ELL sparse FFN (up -> gelu -> down on the same
custom-VJP SpMM the dense-FFN transformer uses); routing is Switch-style
top-1 with a static capacity, dispatched by a stable argsort over expert
assignments (N log N + two scatters/gathers, static shapes — the
production-scale layout; drop decisions are identical to the classic
cumsum-of-one-hot formulation because the sort is stable) plus the
standard load-balancing auxiliary loss.

Two execution layouts:

- ``apply``      — single-device oracle (pure jnp; also what GSPMD
                   partitions when expert params carry an "ep" sharding).
- ``apply_ep``   — explicit expert parallelism inside ``shard_map``:
                   tokens sharded on the mesh axis, experts sharded on the
                   same axis, dispatch/return via two ``lax.all_to_all``
                   collectives riding NVLink.  With ample capacity it equals
                   ``apply`` exactly (tested); under pressure each token
                   shard drops against its local capacity (standard
                   practice — capacity is per-shard at scale).

The reference has no model layer at all (SURVEY §2.7); this extends the
framework's north-star "block-sparse weights" story to conditional
computation, where the FLOPs saved by block sparsity compound with the
FLOPs saved by routing.
"""
from __future__ import annotations

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax
from jax.sharding import Mesh, PartitionSpec as P

from .layers import BlockSparseLinear, dense_apply, dense_init
from ..ops.autodiff import bell_spmm


def _expert_ffn(up_cols, up_nb, up_vals, dn_cols, dn_nb, dn_vals,
                x, d_model, d_ff, block):
    """One expert's up->gelu->down on [C, d_model] tokens (traced arrays
    everywhere so experts can be selected dynamically under shard_map)."""
    Kd = -(-d_model // block) * block
    xp = jnp.pad(x, ((0, 0), (0, Kd - x.shape[1]))) \
        if x.shape[1] < Kd else x
    h = bell_spmm(up_cols, up_nb, up_vals.astype(x.dtype), xp.T).T[:, :d_ff]
    h = jax.nn.gelu(h)
    Kf = -(-d_ff // block) * block
    hp = jnp.pad(h, ((0, 0), (0, Kf - h.shape[1]))) if h.shape[1] < Kf else h
    return bell_spmm(dn_cols, dn_nb, dn_vals.astype(x.dtype), hp.T).T[:, :d_model]


@dataclasses.dataclass(frozen=True)
class BlockSparseMoE:
    """E experts, each a block-sparse FFN; top-1 routed with capacity.

    Static structure (block patterns per expert) lives on the layer;
    trainable leaves (gate + stacked expert vals) in ``init``'s dict.
    """

    d_model: int
    d_ff: int
    block: int
    n_experts: int
    capacity_factor: float
    # stacked static structure: [E, nbr, max_nb] / [E, nbr]
    up_cols: jax.Array
    up_nb: jax.Array
    dn_cols: jax.Array
    dn_nb: jax.Array

    @classmethod
    def create(cls, key, n_experts: int, d_model: int, d_ff: int,
               block: int = 128, block_density: float = 0.5,
               capacity_factor: float = 1.25) -> "BlockSparseMoE":
        keys = jax.random.split(key, 2 * n_experts)
        ups, dns = [], []
        for e in range(n_experts):
            ups.append(BlockSparseLinear.create(
                keys[2 * e], d_ff, d_model, block, block_density))
            dns.append(BlockSparseLinear.create(
                keys[2 * e + 1], d_model, d_ff, block, block_density))
        # stack per-expert structure; max_nb may differ -> pad with the
        # row's last valid column (nb_row bounds the walk, padding unused
        # by the XLA gather but must stay in-range)
        def stack(layers):
            mx = max(la.max_nb for la in layers)
            cols = np.zeros((n_experts, layers[0].cols_idx.shape[0], mx),
                            np.int32)
            nb = np.zeros((n_experts, layers[0].cols_idx.shape[0]), np.int32)
            for e, la in enumerate(layers):
                c = np.asarray(la.cols_idx)
                cols[e, :, : c.shape[1]] = c
                nb[e] = np.asarray(la.nb_row)
            return jnp.asarray(cols), jnp.asarray(nb)

        up_cols, up_nb = stack(ups)
        dn_cols, dn_nb = stack(dns)
        return cls(d_model=d_model, d_ff=d_ff, block=block,
                   n_experts=n_experts, capacity_factor=capacity_factor,
                   up_cols=up_cols, up_nb=up_nb, dn_cols=dn_cols,
                   dn_nb=dn_nb)

    def init(self, key) -> dict:
        E, b = self.n_experts, self.block
        k1, k2, k3 = jax.random.split(key, 3)
        nbr_u, mx_u = self.up_cols.shape[1], self.up_cols.shape[2]
        nbr_d, mx_d = self.dn_cols.shape[1], self.dn_cols.shape[2]
        fan_u, fan_d = mx_u * b, mx_d * b
        return {
            "gate": dense_init(k1, self.n_experts, self.d_model),
            "up_vals": jax.random.normal(
                k2, (E, nbr_u, mx_u, b, b), jnp.float32) / np.sqrt(fan_u),
            "down_vals": jax.random.normal(
                k3, (E, nbr_d, mx_d, b, b), jnp.float32) / np.sqrt(fan_d),
        }

    # -- routing ----------------------------------------------------------
    # Sort-based dispatch: stable argsort by expert gives every token its
    # arrival-order rank within its expert (identical drop decisions to
    # the classic cumsum-of-one-hot formulation) without materializing the
    # O(N*E*C) dispatch tensor — N log N sort + two gathers/scatters, the
    # production-scale MoE layout.
    def _route(self, params, x, capacity: int):
        """x [N, d] -> (slot [N] int32 into the flat [E*C (+1 drop)] slab,
        keep [N] bool, gate_val [N], aux scalar)."""
        E = self.n_experts
        N = x.shape[0]
        logits = dense_apply(params["gate"], x).astype(jnp.float32)
        p = jax.nn.softmax(logits, axis=-1)            # [N, E]
        e = jnp.argmax(p, axis=-1)                     # [N]
        gate_val = jnp.take_along_axis(p, e[:, None], axis=1).squeeze(1)
        counts = jnp.zeros((E,), jnp.int32).at[e].add(1)
        starts = jnp.cumsum(counts) - counts           # [E]
        order = jnp.argsort(e, stable=True)            # tokens grouped
        rank_s = jnp.arange(N, dtype=jnp.int32) - starts[e[order]]
        keep_s = rank_s < capacity
        slot_s = jnp.where(keep_s, e[order] * capacity + rank_s, E * capacity)
        # back to token order (scatter the sorted slots via the inverse)
        slot = jnp.zeros((N,), jnp.int32).at[order].set(slot_s)
        keep = jnp.zeros((N,), bool).at[order].set(keep_s)
        # Switch aux loss: E * sum_e fraction_routed_e * mean_prob_e
        f = (counts / N).astype(jnp.float32)
        pr = p.mean(axis=0)
        aux = E * (f * pr).sum()
        return slot, keep, gate_val, aux

    def _dispatch(self, x, slot, capacity: int):
        """x [N, d] -> expert slabs [E, C, d] (dropped tokens land in the
        trailing garbage slot and are sliced off)."""
        E = self.n_experts
        buf = jnp.zeros((E * capacity + 1, x.shape[1]), jnp.float32)
        buf = buf.at[slot].set(x.astype(jnp.float32))
        return buf[: E * capacity].reshape(E, capacity, x.shape[1])

    @staticmethod
    def _combine(ye, slot, keep, gate_val):
        """ye [E, C, d] -> per-token outputs [N, d] (dropped tokens 0)."""
        flat = ye.reshape(-1, ye.shape[-1]).astype(jnp.float32)
        flat = jnp.concatenate([flat, jnp.zeros((1, ye.shape[-1]),
                                                jnp.float32)])
        return flat[slot] * (gate_val * keep)[:, None]

    def capacity(self, n_tokens: int) -> int:
        return max(int(np.ceil(n_tokens / self.n_experts
                               * self.capacity_factor)), 1)

    # -- single-device oracle ----------------------------------------------
    def apply(self, params, x, *, return_aux: bool = False,
              capacity: int | None = None):
        """x [..., d_model] -> [..., d_model] (tokens over capacity
        contribute zero — the residual stream carries them, as in Switch).

        ``capacity`` overrides the configured factor; pass the token count
        for a dropless pass (what decode/serving uses — a dropped token is
        a training-time regularization artifact, never a serving behavior).
        """
        lead = x.shape[:-1]
        xf = x.reshape(-1, self.d_model)
        N = xf.shape[0]
        C = capacity if capacity is not None else self.capacity(N)
        slot, keep, gate_val, aux = self._route(params, xf, C)
        xe = self._dispatch(xf, slot, C)
        ys = []
        for ei in range(self.n_experts):
            ys.append(_expert_ffn(
                self.up_cols[ei], self.up_nb[ei], params["up_vals"][ei],
                self.dn_cols[ei], self.dn_nb[ei], params["down_vals"][ei],
                xe[ei].astype(x.dtype), self.d_model, self.d_ff, self.block))
        ye = jnp.stack(ys)                              # [E, C, d]
        y = self._combine(ye, slot, keep, gate_val)
        y = y.astype(x.dtype).reshape(*lead, self.d_model)
        return (y, aux) if return_aux else y

    # -- expert-parallel (shard_map + all_to_all) ---------------------------
    def _apply_ep_local(self, params, x, structure, *, axis: str,
                        n_shards: int, return_aux: bool):
        """Shard-local body: x [N_l, d]; experts sharded on ``axis``."""
        E, El = self.n_experts, self.n_experts // n_shards
        up_cols, up_nb, dn_cols, dn_nb = structure  # local [El, ...]
        gate = jax.tree.map(
            lambda a: lax.pcast(a, (axis,), to="varying"), params["gate"])
        N_l = x.shape[0]
        C = self.capacity(N_l)
        slot, keep, gate_val, aux = self._route({"gate": gate}, x, C)
        xe = self._dispatch(x, slot, C)
        # dispatch: every shard sends its [E, C, d] buffer's expert slabs
        # to the experts' owners -> [El, n*C, d] local work
        xa = lax.all_to_all(xe, axis, split_axis=0, concat_axis=1,
                            tiled=True)
        ys = []
        for i in range(El):
            ys.append(_expert_ffn(
                up_cols[i], up_nb[i], params["up_vals"][i],
                dn_cols[i], dn_nb[i], params["down_vals"][i],
                xa[i].astype(x.dtype), self.d_model, self.d_ff, self.block))
        ya = jnp.stack(ys).astype(jnp.float32)          # [El, n*C, d]
        # return trip: give each token shard its capacity slab back
        ye = lax.all_to_all(ya, axis, split_axis=1, concat_axis=0,
                            tiled=True)                 # [E, C, d]
        y = self._combine(ye, slot, keep, gate_val).astype(x.dtype)
        if not return_aux:
            return y
        return y, lax.pmean(aux, axis)

    def apply_ep(self, params, x, mesh: Mesh, axis: str = "ep", *,
                 return_aux: bool = False):
        """Expert-parallel apply: x [N, d_model] with N sharded on
        ``axis``, expert params sharded on the same axis.  Routing and
        capacity are per token shard (each shard's tokens compete only
        for its ``capacity(N/n)`` slots per expert)."""
        n = mesh.shape[axis]
        if self.n_experts % n:
            raise ValueError(f"n_experts={self.n_experts} not divisible by "
                             f"mesh axis {axis}={n}")
        if x.ndim != 2:
            raise ValueError("apply_ep takes flat [N, d_model] tokens")
        specs = {
            "gate": jax.tree.map(lambda _: P(), params["gate"]),
            "up_vals": P(axis), "down_vals": P(axis),
        }
        structure = (self.up_cols, self.up_nb, self.dn_cols, self.dn_nb)
        fn = jax.shard_map(
            functools.partial(self._apply_ep_local, axis=axis, n_shards=n,
                              return_aux=return_aux),
            mesh=mesh,
            in_specs=(specs, P(axis, None),
                      (P(axis), P(axis), P(axis), P(axis))),
            out_specs=(P(axis, None), P()) if return_aux else P(axis, None))
        return fn(params, x, structure)
