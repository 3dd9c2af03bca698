"""Neural-net layers over block-sparse weights.

The reference has no model layer (SURVEY §0); this implements the north
star's "block-sparse transformer weight matrices SpMM batch inference /
training" capability: weight matrices stored in Blocked-ELL, forward =
our bell SpMM (autodiff-ready: gradients flow to the block values through
the same gather structure).

Pure-pytree style: each layer is (init(key) -> params, apply(params, x));
static structure (block indices) lives in the config object, OUTSIDE the
trainable pytree, so optimizers only see float leaves.
"""
from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np

from ..definitions import ceil_div
from ..ops.autodiff import bell_spmm


def make_block_mask(
    out_dim: int, in_dim: int, block: int, block_density: float, key
) -> tuple[np.ndarray, np.ndarray]:
    """Random block-sparsity pattern: (cols_idx [nbr, max_nb], nb_row [nbr]).

    Every block-row keeps the same number of blocks (balanced, tile-friendly)
    = the 80-95%-sparse pruned-weight layout of the north star's config.
    """
    nbr, nbc = ceil_div(out_dim, block), ceil_div(in_dim, block)
    per_row = max(1, round(nbc * block_density))
    rng = np.random.default_rng(np.asarray(jax.random.key_data(key)).sum())
    cols = np.stack(
        [np.sort(rng.choice(nbc, size=per_row, replace=False)) for _ in range(nbr)]
    ).astype(np.int32)
    nb_row = np.full(nbr, per_row, dtype=np.int32)
    return cols, nb_row


@dataclasses.dataclass(frozen=True)
class BlockSparseLinear:
    """y = x @ W^T (+ b), W [out_dim, in_dim] in Blocked-ELL."""

    out_dim: int
    in_dim: int
    block: int
    cols_idx: jax.Array  # [nbr, max_nb] int32
    nb_row: jax.Array    # [nbr] int32
    use_bias: bool = True

    @classmethod
    def create(cls, key, out_dim, in_dim, block=128, block_density=0.15,
               use_bias=True) -> "BlockSparseLinear":
        cols, nb = make_block_mask(out_dim, in_dim, block, block_density, key)
        return cls(out_dim, in_dim, block, jnp.asarray(cols), jnp.asarray(nb),
                   use_bias)

    @classmethod
    def from_dense(cls, W, block=128, block_density=0.15, bias=None,
                   per_row: bool = True):
        """Prune a dense weight [out_dim, in_dim] to block-sparse by block
        Frobenius norm (the 'pruned BERT-style weight matrices' path of the
        north star).  Returns (layer, params).

        per_row=True keeps the same number of blocks in every block-row
        (balanced, tile-friendly); False keeps the global top-k blocks.
        """
        W = np.asarray(W, dtype=np.float32)
        out_dim, in_dim = W.shape
        nbr, nbc = ceil_div(out_dim, block), ceil_div(in_dim, block)
        Wp = np.zeros((nbr * block, nbc * block), dtype=np.float32)
        Wp[:out_dim, :in_dim] = W
        norms = np.linalg.norm(
            Wp.reshape(nbr, block, nbc, block).transpose(0, 2, 1, 3),
            axis=(2, 3),
        )  # [nbr, nbc]
        if per_row:
            keep = max(1, round(nbc * block_density))
            cols = np.sort(np.argsort(-norms, axis=1)[:, :keep], axis=1).astype(np.int32)
            nb_row = np.full(nbr, keep, dtype=np.int32)
            max_nb = keep
        else:
            k = max(1, round(nbr * nbc * block_density))
            flat = np.argsort(-norms.ravel())[:k]
            br, bc = flat // nbc, flat % nbc
            nb_row = np.bincount(br, minlength=nbr).astype(np.int32)
            max_nb = max(int(nb_row.max()), 1)
            cols = np.full((nbr, max_nb), -1, dtype=np.int32)
            for r in range(nbr):
                sel = np.sort(bc[br == r])
                cols[r, : sel.size] = sel
        vals = np.zeros((nbr, max_nb, block, block), dtype=np.float32)
        for r in range(nbr):
            for t in range(int(nb_row[r])):
                jb = cols[r, t]
                vals[r, t] = Wp[r * block:(r + 1) * block,
                                jb * block:(jb + 1) * block]
        layer = cls(out_dim, in_dim, block, jnp.asarray(cols),
                    jnp.asarray(nb_row), use_bias=bias is not None)
        params = {"vals": jnp.asarray(vals)}
        if bias is not None:
            params["bias"] = jnp.asarray(bias, dtype=jnp.float32)
        return layer, params

    @property
    def max_nb(self) -> int:
        return self.cols_idx.shape[1]

    def init(self, key) -> dict:
        nbr = self.cols_idx.shape[0]
        # fan-in of each output row = stored blocks * block width
        fan_in = self.max_nb * self.block
        w = jax.random.normal(
            key, (nbr, self.max_nb, self.block, self.block), dtype=jnp.float32
        ) * (1.0 / np.sqrt(fan_in))
        params = {"vals": w}
        if self.use_bias:
            params["bias"] = jnp.zeros((self.out_dim,), dtype=jnp.float32)
        return params

    def apply(self, params, x: jax.Array) -> jax.Array:
        """x: [..., in_dim] -> [..., out_dim]."""
        lead = x.shape[:-1]
        x2 = x.reshape(-1, x.shape[-1])
        K = ceil_div(self.in_dim, self.block) * self.block
        if x2.shape[1] < K:
            x2 = jnp.pad(x2, ((0, 0), (0, K - x2.shape[1])))
        # custom-VJP SpMM: routed forward (the Triton kernel on the GPU),
        # XLA backward; padding blocks get exactly-zero gradients so pruned
        # weights stay pruned
        y = bell_spmm(
            self.cols_idx, self.nb_row, params["vals"].astype(x.dtype),
            x2.T,
        ).T[:, : self.out_dim]
        if self.use_bias:
            y = y + params["bias"].astype(y.dtype)
        return y.reshape(*lead, self.out_dim)

    def density(self) -> float:
        nbr = self.cols_idx.shape[0]
        return float(nbr * self.max_nb * self.block * self.block) / (
            self.out_dim * self.in_dim
        )

    def freeze(self, params, batch_hint: int = 512, dtype=None,
               activation: str | None = None):
        """Inference-optimized apply: pick the fastest path for the trained
        weights (ops.plan_spmm).  When the blocked kernel wins, the bias
        add (and optional ``activation='relu'``) runs in the kernel's
        epilogue, so the output makes one trip to device memory instead of
        three.

        Returns ``apply(x) -> y`` closed over the frozen weights. Training
        keeps the ELL layout (the custom VJP's gradients are shaped like
        ``params['vals']``); freeze once when weights stop changing."""
        from ..formats.bell import BELL
        from ..ops import BellDevice, bell_spmm_triton, plan_spmm

        if activation not in (None, "relu"):
            raise ValueError(f"unsupported activation {activation!r}")
        nbr = self.cols_idx.shape[0]
        nbc = ceil_div(self.in_dim, self.block)
        bell = BELL(
            cols_idx=np.asarray(self.cols_idx),
            vals=np.asarray(params["vals"], dtype=np.float32),
            nb_row=np.asarray(self.nb_row),
            row_perm=np.arange(nbr * self.block),
            block_row_size=self.block,
            block_col_size=self.block,
            shape=(nbr * self.block, nbc * self.block),
            orig_shape=(self.out_dim, self.in_dim),
        )
        plan_dtype = dtype or jnp.bfloat16
        plan = plan_spmm(bell, batch_hint, dtype=plan_dtype)
        bias = params.get("bias") if self.use_bias else None
        K = nbc * self.block
        out_dim = self.out_dim

        fused = None
        if plan.backend == "bell_triton":
            dev = BellDevice.from_host(bell, dtype=plan_dtype)
            bias_pad = None
            if bias is not None:
                bias_pad = jnp.zeros((nbr * self.block,), jnp.float32)
                bias_pad = bias_pad.at[:out_dim].set(bias.astype(jnp.float32))
            # release the plan: its closure holds an identical device copy
            plan = None

            def fused(xt, dev=dev, bias_pad=bias_pad):
                return bell_spmm_triton(dev, xt, bias=bias_pad,
                                        relu=activation == "relu")

        def apply(x: jax.Array) -> jax.Array:
            lead = x.shape[:-1]
            x2 = x.reshape(-1, x.shape[-1]).astype(plan_dtype)
            if x2.shape[1] < K:
                x2 = jnp.pad(x2, ((0, 0), (0, K - x2.shape[1])))
            xt = x2.T
            if fused is not None:
                y = fused(xt)[:out_dim].T
            else:
                y = plan(xt)[:out_dim].T
                if bias is not None:
                    y = y + bias.astype(y.dtype)
                if activation == "relu":
                    y = jax.nn.relu(y)
            return y.reshape(*lead, out_dim)

        return apply


def dense_init(key, out_dim, in_dim) -> dict:
    return {
        "w": jax.random.normal(key, (in_dim, out_dim), dtype=jnp.float32)
        / np.sqrt(in_dim),
        "b": jnp.zeros((out_dim,), dtype=jnp.float32),
    }


def dense_apply(params, x):
    return x @ params["w"].astype(x.dtype) + params["b"].astype(x.dtype)


def layernorm_init(dim) -> dict:
    return {"scale": jnp.ones((dim,)), "bias": jnp.zeros((dim,))}


def layernorm_apply(params, x, eps=1e-5):
    mean = x.mean(-1, keepdims=True)
    var = ((x - mean) ** 2).mean(-1, keepdims=True)
    y = (x - mean) * jax.lax.rsqrt(var + eps)
    return y * params["scale"].astype(x.dtype) + params["bias"].astype(x.dtype)
