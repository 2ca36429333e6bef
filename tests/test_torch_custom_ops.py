"""The kernels as ``torch.library`` custom ops (``s2tpu_torch::...``): ``torch.library.opcheck`` on the CPU.

Each op's CPU implementation is its kernel's plain version, and its fake
version must give the shapes, dtypes and strides that implementation
gives: ``opcheck`` runs the schema, fake-tensor, autograd-registration and
AOT-dispatch tests of each op at tiny sizes (the card's implementations are
checked the same way in ``tests/test_torch_cuda_kernels.py``).
"""

import pytest
import torch

from s2tpu_torch.ops import batchnorm_act, depthwise_conv, flash_attention, fused_ce  # noqa: F401 (registers the ops)


def op_cases(device: str = "cpu") -> dict[str, tuple]:
    """Arguments of each custom op at tiny sizes: f32 and bf16 where the
    kernels take both; attention on the fused route (L = 130) and past it."""
    g = torch.Generator().manual_seed(0)

    def r(*shape, dtype=torch.float32):
        return torch.randn(*shape, generator=g).to(device=device, dtype=dtype)

    cases = {}
    for dtype in (torch.float32, torch.bfloat16):
        tag = str(dtype).split(".")[-1]
        x, w = r(2, 6, 5, 8, dtype=dtype), r(3, 3, 8, dtype=dtype)
        cases[f"depthwise_conv2d_s1-{tag}"] = (torch.ops.s2tpu_torch.depthwise_conv2d_s1, (x, w))
        cases[f"depthwise_conv2d_s1_input_grad-{tag}"] = (torch.ops.s2tpu_torch.depthwise_conv2d_s1_input_grad, (x, w))
        cases[f"depthwise_conv2d_s1_grad_weight-{tag}"] = (
            torch.ops.s2tpu_torch.depthwise_conv2d_s1_grad_weight, (x, r(2, 6, 5, 8, dtype=dtype), 3))
        qkv = r(2, 130, 3 * 64, dtype=dtype)
        out = flash_attention.fused_attention_dense_forward_reference(qkv, 2)
        cases[f"fused_attention_dense_forward-{tag}"] = (torch.ops.s2tpu_torch.fused_attention_dense_forward, (qkv, 2))
        cases[f"fused_attention_dense_backward-{tag}"] = (
            torch.ops.s2tpu_torch.fused_attention_dense_backward, (qkv, out, r(*out.shape, dtype=dtype), 2))
        hm = r(3, 2, 2, 20, 32, dtype=dtype)
        hm_out = flash_attention.fused_attention_qkv_forward_reference(hm)
        cases[f"fused_attention_qkv_forward-{tag}"] = (torch.ops.s2tpu_torch.fused_attention_qkv_forward, (hm,))
        cases[f"fused_attention_qkv_backward-{tag}"] = (
            torch.ops.s2tpu_torch.fused_attention_qkv_backward, (hm, hm_out, r(*hm_out.shape, dtype=dtype)))
        q, k, v = r(2, 520, 3 * 64, dtype=dtype).reshape(2, 520, 3, 2, 32).unbind(2)  # strided views
        cases[f"flash_attention_forward-{tag}"] = (torch.ops.s2tpu_torch.flash_attention_forward, (q, k, v))
        bn_x, bn_dy = (r(2, 8, 5, 3, dtype=dtype).contiguous(memory_format=torch.channels_last) for _ in range(2))
        saved = torch.stack([r(8), r(8).abs() + 0.5, torch.ones(8, device=device)])
        gamma, beta = r(8), r(8)
        cases[f"batchnorm_act_stats-{tag}"] = (torch.ops.s2tpu_torch.batchnorm_act_stats, (bn_x,))
        cases[f"batchnorm_act_apply-{tag}"] = (torch.ops.s2tpu_torch.batchnorm_act_apply, (bn_x, saved, gamma, beta, 1))
        cases[f"batchnorm_act_backward_sums-{tag}"] = (
            torch.ops.s2tpu_torch.batchnorm_act_backward_sums, (bn_x, bn_dy, saved, gamma, beta, 1))
        cases[f"batchnorm_act_backward_dx-{tag}"] = (
            torch.ops.s2tpu_torch.batchnorm_act_backward_dx, (bn_x, bn_dy, saved, gamma, beta, r(2, 8), 30.0, 2))
    running = (r(8), r(8).abs(), torch.zeros((), dtype=torch.int64, device=device))
    cases["batchnorm_act_finalize-update"] = (
        torch.ops.s2tpu_torch.batchnorm_act_finalize, (r(2, 8).abs() * 30.0, *running, 30.0, 1e-3, 0.9, True))
    logits = r(40, 4)
    labels = torch.randint(0, 4, (40,), generator=g, dtype=torch.int32).to(device)
    weights, cot = r(4).abs(), r(40)
    for name, mode in (("ce", (None, None)), ("focal_ignore", (0, 2.0))):
        cases[f"fused_ce_forward-{name}"] = (torch.ops.s2tpu_torch.fused_ce_forward, (logits, labels, weights, *mode))
        cases[f"fused_ce_backward-{name}"] = (
            torch.ops.s2tpu_torch.fused_ce_backward, (logits, labels, weights, cot, *mode))
    return cases


@pytest.mark.parametrize("case", list(op_cases()))
def test_opcheck_cpu(case):
    op, args = op_cases()[case]
    torch.library.opcheck(op, args)


def test_every_kernel_entry_is_an_op():
    names = {case.split("-")[0] for case in op_cases()}
    assert names == {
        "depthwise_conv2d_s1", "depthwise_conv2d_s1_input_grad", "depthwise_conv2d_s1_grad_weight",
        "fused_ce_forward", "fused_ce_backward", "fused_attention_dense_forward", "fused_attention_dense_backward",
        "fused_attention_qkv_forward", "fused_attention_qkv_backward", "flash_attention_forward",
        "batchnorm_act_stats", "batchnorm_act_finalize", "batchnorm_act_apply", "batchnorm_act_backward_sums",
        "batchnorm_act_backward_dx",
    }
