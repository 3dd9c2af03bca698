"""Process set-up, device reporting, timing and native builds — plus the
chip smoke script's control flow at tiny sizes."""
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest

ROOT = Path(__file__).resolve().parent.parent


def test_compile_cache_respects_env(monkeypatch):
    from sparta_tpu import runtime

    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", "/some/where")
    before = jax.config.jax_compilation_cache_dir
    assert runtime.setup_compile_cache() == "/some/where"
    assert jax.config.jax_compilation_cache_dir == before  # sets nothing


def test_compile_cache_default_is_repo_local(monkeypatch):
    from sparta_tpu import runtime

    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    before = jax.config.jax_compilation_cache_dir
    try:
        got = runtime.setup_compile_cache()
        assert got == str(ROOT / ".jax_cache")
        assert jax.config.jax_compilation_cache_dir == got
    finally:
        jax.config.update("jax_compilation_cache_dir", before)
    assert ".jax_cache/" in (ROOT / ".gitignore").read_text()


def test_device_info_names_the_device():
    from sparta_tpu.runtime import device_info

    info = device_info()
    assert info["platform"] == "cpu"
    assert info["count"] == len(jax.devices())
    assert set(info) == {"platform", "kind", "count", "card"}


def test_require_gpu_fails_on_cpu():
    from sparta_tpu.runtime import require_gpu

    with pytest.raises(SystemExit):
        require_gpu()


def test_peak_table_h100():
    from sparta_tpu.bench.peaks import peak_flops, peaks_for

    p = peaks_for("NVIDIA H100 80GB HBM3")
    assert p["bf16_tflops"] == 989.0 and p["hbm_tbps"] == 3.35
    assert peak_flops("NVIDIA H100 80GB HBM3", jnp.bfloat16) == 989e12
    assert peak_flops("NVIDIA H100 80GB HBM3", jnp.int8) == 1979e12


@pytest.mark.parametrize("kind", ["cpu", "Unknown Accelerator", "NVIDIA A100"])
def test_peak_table_unknown_device_raises(kind):
    from sparta_tpu.bench.peaks import peak_flops, peaks_for

    with pytest.raises(KeyError, match="no published peaks"):
        peaks_for(kind)
    with pytest.raises(KeyError):
        peak_flops(kind, jnp.bfloat16)


def test_time_op_blocks_and_returns_output():
    from sparta_tpu.bench.timing import time_op

    calls = []

    def fn(b):
        calls.append(1)
        return b * 2

    x = jnp.ones((8, 8))
    med, std, out = time_op(fn, x, warmup=2, reps=3, inner_iters=4)
    assert med > 0 and std >= 0
    np.testing.assert_array_equal(np.asarray(out), 2 * np.ones((8, 8)))
    assert len(calls) == 2 + 3 * 4


def test_native_library_keyed_by_source_flags_host(tmp_path, monkeypatch):
    import platform

    from sparta_tpu import native_build

    src = tmp_path / "x.cc"
    src.write_text("int f() { return 1; }\n")
    a = native_build.library_path(src, "x", ["-O3"])
    assert a == native_build.library_path(src, "x", ["-O3"])
    assert a != native_build.library_path(src, "x", ["-O2"])
    src.write_text("int f() { return 2; }\n")
    b = native_build.library_path(src, "x", ["-O3"])
    assert b != a
    real = platform.uname()
    monkeypatch.setattr(platform, "uname",
                        lambda: real._replace(node=real.node + "-other"))
    assert native_build.library_path(src, "x", ["-O3"]) != b


def test_chip_smoke_fails_without_gpu(tmp_path):
    """On the CPU the smoke script exits non-zero and prints no result; in
    a directory with nothing else of the repo it fails too."""
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    r = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py")],
                       capture_output=True, text=True, env=env, timeout=300,
                       cwd=ROOT)
    assert r.returncode != 0
    assert '"ok"' not in r.stdout
    alone = tmp_path / "chip_smoke.py"
    alone.write_text((ROOT / "chip_smoke.py").read_text())
    env["PYTHONPATH"] = ""
    r = subprocess.run([sys.executable, str(alone)], capture_output=True,
                       text=True, env=env, timeout=300, cwd=tmp_path)
    assert r.returncode != 0 and '"ok"' not in r.stdout


def test_bench_requires_gpu_without_quick():
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    r = subprocess.run([sys.executable, str(ROOT / "bench.py")],
                       capture_output=True, text=True, env=env, timeout=300,
                       cwd=ROOT)
    assert r.returncode != 0 and not r.stdout.strip()


@pytest.fixture
def kernel_everywhere(monkeypatch):
    """Route every tileable block through the kernel, in the interpreter,
    so the smoke phases run their GPU control flow on the CPU."""
    import sparta_tpu.ops as ops
    import sparta_tpu.ops.blocked as blk
    import sparta_tpu.ops.select as sel

    real_route, real_kernel = blk.spmm_route, blk.bell_spmm_triton

    def route(bh, bw, interpret=False):
        return "xla" if blk._FORCED_XLA else real_route(bh, bw, True)

    def kernel(*a, **k):
        k["interpret"] = True
        return real_kernel(*a, **k)

    for mod in (blk, sel, ops):
        monkeypatch.setattr(mod, "spmm_route", route)
        monkeypatch.setattr(mod, "bell_spmm_triton", kernel)
    sys.path.insert(0, str(ROOT))
    import chip_smoke

    yield chip_smoke
    sys.path.remove(str(ROOT))


def test_chip_smoke_spmm_phase_small(kernel_everywhere, monkeypatch,
                                     tmp_path):
    monkeypatch.setenv("SPARTA_TPU_AUTOTUNE_CACHE", "0")
    kernel_everywhere.phase_spmm(n=512, N=64, taus=(0.3,),
                                 suite_sizes=((12, 12), 7, 512))


def test_chip_smoke_train_phase_small(kernel_everywhere):
    kernel_everywhere.phase_train(d_model=128, n_heads=2, n_layers=1,
                                  d_ff=256, T=256, batch=1, vocab=256,
                                  steps=2)


def test_chip_smoke_gcn_phase_small(kernel_everywhere):
    kernel_everywhere.phase_gcn(grid=6, feat=16, hidden=16, classes=4)


def test_chip_smoke_four_phase_small(kernel_everywhere):
    kernel_everywhere.phase_four(n=512, N=64, d_model=128, n_heads=2,
                                 n_layers=1, d_ff=256, T=256, vocab=256)


def test_chip_smoke_four_phase_catches_unreduced_grads(kernel_everywhere,
                                                      monkeypatch):
    """The four-card check compares gradients, not only the loss: a step
    whose gradient sees one dp shard's half of the batch must fail it."""
    import functools

    import optax

    import sparta_tpu.models.train as train

    real = train.make_sharded_train_step

    def half_batch(model, optimizer, mesh):
        init, _ = real(model, optimizer, mesh)

        @jax.jit
        def step(params, opt_state, tokens):
            loss = train.lm_loss(model, params, tokens)
            grads = jax.grad(functools.partial(train.lm_loss, model))(
                params, tokens[: tokens.shape[0] // 2])
            updates, opt_state = optimizer.update(grads, opt_state, params)
            return optax.apply_updates(params, updates), opt_state, loss

        return init, step

    monkeypatch.setattr(train, "make_sharded_train_step", half_batch)
    with pytest.raises(kernel_everywhere.SmokeFailure, match="gradients"):
        kernel_everywhere.phase_four(n=512, N=64, d_model=128, n_heads=2,
                                     n_layers=1, d_ff=256, T=256, vocab=256)


def test_chip_smoke_check_raises_past_tolerance():
    sys.path.insert(0, str(ROOT))
    try:
        import chip_smoke
    finally:
        sys.path.remove(str(ROOT))
    assert chip_smoke.rel_err(np.ones(3), np.ones(3)) == 0.0
    with pytest.raises(chip_smoke.SmokeFailure):
        chip_smoke.check("x", np.array([1.1]), np.array([1.0]), 1e-2, "why")
    with pytest.raises(chip_smoke.SmokeFailure):
        chip_smoke.check("nan", np.array([np.nan]), np.array([1.0]), 1.0,
                         "why")


@pytest.mark.gpu
def test_kernel_compiles_on_gpu(gpu_device):
    """The Triton kernel compiled for the card equals the XLA path."""
    from sparta_tpu.formats import bell_from_csr, random_block_csr
    from sparta_tpu.ops import BellDevice, bell_spmm_triton, bell_spmm_xla

    m = random_block_csr(1024, 1024, block=128, block_density=0.2, seed=1)
    bell = bell_from_csr(m, None, block_row_size=128)
    dev = BellDevice.from_host(bell, dtype=jnp.bfloat16)
    B = jnp.asarray(np.random.default_rng(0).standard_normal((1024, 256)),
                    jnp.bfloat16)
    got = np.asarray(bell_spmm_triton(dev, B), np.float32)
    want = np.asarray(bell_spmm_xla(dev, B), np.float32)
    np.testing.assert_allclose(got, want, rtol=2e-2, atol=2e-2)
