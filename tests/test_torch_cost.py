"""The port's cost counter (`repro_torch.launch.hlo_cost`) on the CPU,
held to exact hand counts and to the reference's HLO counter
(`repro.launch.hlo_cost.analyze`) on the reference's own programs:
  * flops of a 10-step chain of 128 x 128 products and of a 3 x 5
    nested chain at 64, exactly 2 * 128^3 * 10 and 2 * 64^3 * 15, and
    within 1 % of the reference's count of the same programs (the
    reference test's tolerance);
  * HBM bytes of one [64, 128] @ [128, 32] float32 product, operands
    and output;
  * each LLM kernel op (`wkv`, `wkv_backward`, `mamba_scan`,
    `mamba_scan_backward`, `flash_attention`) counts one op with exactly
    its `*_flops` / `*_hbm_bytes`, on real CPU tensors and on fake
    tensors alike, fake tensors give the kernel's shapes and launch
    nothing, and autograd through a kernel op counts its backward op;
  * in a spawned gloo world of 4 ranks, the all-gather of a [4, 8]
    float32 shard counts 4 x 128 = 512 all-gather bytes, and an op on a
    `DTensor` counts its local shard once;
  * the peak bytes of a hand-counted program.
"""

import jax
import jax.numpy as jnp
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.kernels.mamba_scan import ops as scan_ops
from repro_torch.kernels.rwkv6 import ops as wkv_ops
from repro_torch.launch import hlo_cost
from _torch_dryrun_world import collectives_body
from _torch_mesh_world import run_world
from _torch_parity import one_thread as _one_thread  # noqa: F401


def _chain(x):
    for _ in range(10):
        x = x @ x
    return x


def _nested(x):
    for _ in range(3):
        for _ in range(5):
            x = x @ x
    return x


def _ref_chain(x):
    return jax.lax.scan(lambda c, _: (c @ c, None), x, None, length=10)[0]


def _ref_nested(x):
    def outer(c, _):
        return jax.lax.scan(lambda c2, _: (c2 @ c2, None), c, None,
                            length=5)[0], None
    return jax.lax.scan(outer, x, None, length=3)[0]


@pytest.mark.parametrize("name,fn,ref_fn,n,want", [
    ("chain", _chain, _ref_chain, 128, 41_943_040),
    ("nested", _nested, _ref_nested, 64, 7_864_320)])
def test_loops_count_every_trip(name, fn, ref_fn, n, want):
    from repro.launch.hlo_cost import analyze as ref_analyze
    got = hlo_cost.analyze(fn, torch.randn(n, n))
    assert got["flops"] == want == 2 * n ** 3 * (10 if n == 128 else 15)
    assert got["collectives"] == {} and got["collective_bytes"] == 0
    compiled = jax.jit(ref_fn).lower(
        jax.ShapeDtypeStruct((n, n), jnp.float32)).compile()
    ref = ref_analyze(compiled.as_text())["flops"]
    assert abs(got["flops"] - ref) / ref < 0.01, (got["flops"], ref)


def test_product_bytes_are_operands_and_output():
    got = hlo_cost.analyze(lambda a, b: a @ b, torch.randn(64, 128),
                           torch.randn(128, 32))
    assert got["hbm_bytes"] == 57_344 == 4 * (64 * 128 + 128 * 32 + 64 * 32)
    assert got["flops"] == 2 * 64 * 32 * 128


def _wkv_case(b=1, t=40, h=2, d=8):
    g = torch.Generator().manual_seed(0)
    r, k, v = (torch.randn((b, t, h, d), generator=g) for _ in range(3))
    w = -torch.rand((b, t, h, d), generator=g)
    u = torch.randn((h, d), generator=g)
    chunks = torch.zeros((-(-t // wkv_ops.CHUNK), b, h, d, d))
    return {"wkv": (lambda: wkv_ops.wkv(r, k, v, w, u),
                    "repro_torch::wkv", wkv_ops.wkv_flops(b, t, h, d),
                    wkv_ops.wkv_hbm_bytes(b, t, h, d)),
            "wkv_backward": (
                lambda: wkv_ops.wkv_backward(r, k, v, w, u, chunks, r),
                "repro_torch::wkv_bwd", wkv_ops.wkv_bwd_flops(b, t, h, d),
                wkv_ops.wkv_bwd_hbm_bytes(b, t, h, d))}


def _scan_case(b=2, t=20, di=6, ds=4):
    g = torch.Generator().manual_seed(1)
    x, dt = (torch.randn((b, t, di), generator=g) for _ in range(2))
    bm, cm = (torch.randn((b, t, ds), generator=g) for _ in range(2))
    a = -torch.rand((di, ds), generator=g)
    chunks = torch.zeros((-(-t // scan_ops.SPAN), b, di, ds))
    return {"mamba_scan": (
                lambda: scan_ops.mamba_scan(x, dt, bm, cm, a),
                "repro_torch::mamba_scan",
                scan_ops.mamba_scan_flops(b, t, di, ds),
                scan_ops.mamba_scan_hbm_bytes(b, t, di, ds)),
            "mamba_scan_backward": (
                lambda: scan_ops.mamba_scan_backward(x, dt, bm, cm, a,
                                                     chunks, x),
                "repro_torch::mamba_scan_bwd",
                scan_ops.mamba_scan_bwd_flops(b, t, di, ds),
                scan_ops.mamba_scan_bwd_hbm_bytes(b, t, di, ds))}


def _flash_case(b=1, s=24, hq=4, hkv=2, d=8):
    g = torch.Generator().manual_seed(2)
    q = torch.randn((b, s, hq, d), generator=g)
    k, v = (torch.randn((b, s, hkv, d), generator=g) for _ in range(2))
    return {"flash_attention": (
        lambda: flash_ops.flash_attention(q, k, v),
        "repro_torch::flash_attention",
        flash_ops.attention_flops(b, s, s, hq, d),
        flash_ops.attention_hbm_bytes(b, s, s, hq, hkv, d))}


def _cases():
    return {**_wkv_case(), **_scan_case(), **_flash_case()}


def _launches():
    return (wkv_ops.wkv.launches, wkv_ops.wkv_backward.launches,
            scan_ops.mamba_scan.launches,
            scan_ops.mamba_scan_backward.launches,
            flash_ops.flash_attention.launches)


@pytest.mark.parametrize("fake", [False, True], ids=["cpu", "fake"])
@pytest.mark.parametrize("kernel", ["wkv", "wkv_backward", "mamba_scan",
                                    "mamba_scan_backward",
                                    "flash_attention"])
def test_kernel_counts_its_own_work_once(kernel, fake):
    """One op named for the kernel, with exactly the kernel's flops and
    bytes and none of its plain version's inner ops; on fake tensors the
    outputs have the plain version's shapes and nothing launches."""
    before = _launches()
    if fake:
        with FakeTensorMode():
            fn, op, flops, nbytes = _cases()[kernel]
            out, counter, _ = hlo_cost.count(fn)
    else:
        fn, op, flops, nbytes = _cases()[kernel]
        out, counter, _ = hlo_cost.count(fn)
    assert counter.ops == {op: [1, float(flops), float(nbytes)]}, counter.ops
    assert counter.costs.flops == flops and counter.costs.hbm_bytes == nbytes
    assert _launches() == before
    if fake:
        real = _cases()[kernel][0]()
        outs = out if isinstance(out, tuple) else (out,)
        reals = real if isinstance(real, tuple) else (real,)
        assert [None if o is None else (tuple(o.shape), o.dtype)
                for o in outs] == [None if o is None else
                                   (tuple(o.shape), o.dtype) for o in reals]


def _grad_run(kernel):
    """A forward through the kernel op that requires grad, then its
    backward: (the run, the backward op's name and flops)."""
    g = torch.Generator().manual_seed(3)
    if kernel == "wkv":
        xs = [torch.randn((1, 32, 2, 8), generator=g).requires_grad_()
              for _ in range(3)]
        w = (-torch.rand((1, 32, 2, 8), generator=g)).requires_grad_()
        u = torch.randn((2, 8), generator=g).requires_grad_()

        def run():
            o, _ = wkv_ops.wkv(*xs, w, u)
            o.sum().backward()
        return run, "repro_torch::wkv_bwd", wkv_ops.wkv_bwd_flops(1, 32, 2,
                                                                   8)
    xs = [torch.randn((1, 24, 4), generator=g).requires_grad_()
          for _ in range(2)]
    bc = [torch.randn((1, 24, 3), generator=g).requires_grad_()
          for _ in range(2)]
    a = (-torch.rand((4, 3), generator=g)).requires_grad_()

    def run():
        y, _ = scan_ops.mamba_scan(*xs, *bc, a)
        y.sum().backward()
    return run, "repro_torch::mamba_scan_bwd", scan_ops.mamba_scan_bwd_flops(
        1, 24, 4, 3)


@pytest.mark.parametrize("kernel", ["wkv", "mamba_scan"])
def test_autograd_counts_the_backward_op(kernel):
    """The kernel op and its backward op once each, beside the loss's
    own ops, and no other kernel op."""
    run, bwd, bwd_flops = _grad_run(kernel)
    _, counter, _ = hlo_cost.count(run)
    fwd = f"repro_torch::{kernel}"
    assert counter.ops[bwd][:2] == [1, float(bwd_flops)]
    assert counter.ops[fwd][0] == 1
    assert {k for k in counter.ops if k.startswith("repro_torch::")} == {
        fwd, bwd}


def test_collectives_count_result_bytes_in_a_world_of_four(tmp_path):
    out = run_world(4, collectives_body, None, tmp_path)
    for rank in out:
        assert rank["gather"]["collectives"] == {"all-gather": 512.0}
        assert rank["gather"]["collective_bytes"] == 512.0
        # atan2 of the local [4, 8] shard only: 32 flops, counted once
        assert rank["ops"] == {"aten::atan2": [1, 32.0, 3 * 128.0]}
        assert rank["flops"] == 32.0


def test_peak_bytes_of_a_hand_counted_program():
    def prog(x):                    # x: 1024 float32 = 4096 bytes
        y = x * 2                   # live 4096
        z = torch.cat([y, y])       # live 4096 + 8192
        del y                       # live 8192
        w = z[:1024] + 1            # live 8192 + 4096: the peak, 12288
        del z                       # live 4096
        return w.sum()              # live 4096 + 4
    out, mode, mem = hlo_cost.count(prog, torch.randn(1024))
    assert mode.peak_created == 12_288
    assert mem == {"argument_bytes": 4096, "output_bytes": 4,
                   "temp_bytes": 12_288, "peak_bytes": 16_384}
