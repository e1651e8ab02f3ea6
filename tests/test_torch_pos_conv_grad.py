"""AV-HuBERT's positional conv under autograd (``models/avhubert.py``):
``_GroupedConv1d`` computes the input gradient of a stride-1 grouped
Conv1d as a forward conv of the output gradient with the regrouped,
flipped kernel, and the weight and bias gradients through
``convolution_backward`` without the input's.

On the CPU each test but the counter's runs both through the Function and
through autograd of plain ``F.conv1d`` (the path the module took before
the Function), so the tests hold the two to one another: ``gradcheck`` in
float64 at odd and even kernels and 1, 2 and 4 groups, fp32 and bf16
gradients, ``WeightNormConv1d``'s ``weight_g`` and ``weight_v`` gradients,
and the forward under ``no_grad`` bit-equal to ``F.conv1d``. The counter
``avhubert.pos_conv_input_grad`` adds one per input gradient. On the card:
the cell's shape ([8, 1024, 250] bf16, kernel 128, 16 groups), whose
backward launches no backward-data convolution kernel.
"""

import pytest
import torch
import torch.nn.functional as F

from avsl_tpu_torch.models.avhubert import WeightNormConv1d, _GroupedConv1d
from avsl_tpu_torch.utils import spans


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _plain(x, w, b, padding, groups):
    return F.conv1d(x, w, b, padding=padding, groups=groups)


def _function(x, w, b, padding, groups):
    return _GroupedConv1d.apply(x, w, b, padding, groups)


CONVS = pytest.mark.parametrize("conv", [_function, _plain], ids=["function", "plain"])


def _operands(batch, channels, length, kernel, groups, dtype, rows_first=True, seed=0):
    """``x`` [B, C, T] (the transpose of a [B, T, C] row, as ``pos_conv``
    gets it, or contiguous), ``w`` [C, C/groups, k], ``b`` [C], each
    requiring its gradient."""
    g = torch.Generator().manual_seed(seed)
    if rows_first:
        x = torch.randn(batch, length, channels, generator=g).to(dtype).transpose(1, 2)
    else:
        x = torch.randn(batch, channels, length, generator=g).to(dtype)
    w = (torch.randn(channels, channels // groups, kernel, generator=g)
         / (channels // groups * kernel) ** 0.5).to(dtype)
    b = torch.randn(channels, generator=g).to(dtype)
    return [t.detach().requires_grad_() for t in (x, w, b)]


@CONVS
@pytest.mark.parametrize("kernel", [3, 8])
@pytest.mark.parametrize("groups", [1, 2, 4])
@pytest.mark.parametrize("length", [5, 12])
def test_torch_pos_conv_gradcheck(conv, kernel, groups, length):
    """Input, weight and bias gradients against finite differences in
    float64, at padding k // 2 as the module builds it."""
    x, w, b = _operands(2, 4, length, kernel, groups, torch.float64)
    assert torch.autograd.gradcheck(lambda x, w, b: conv(x, w, b, kernel // 2, groups),
                                    (x, w, b))


@CONVS
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5), (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("kernel,groups,rows_first", [(3, 1, True), (8, 4, True),
                                                      (32, 8, True), (16, 4, False),
                                                      (7, 2, False)])
def test_torch_pos_conv_grads_match_plain_autograd(conv, dtype, tol, kernel, groups, rows_first):
    """fp32 and bf16 gradients of every operand against autograd through
    plain ``F.conv1d``, relative to the largest reference entry; the
    input gradient keeps the input's shape."""
    x, w, b = _operands(3, 16, 20, kernel, groups, dtype, rows_first)
    p = kernel // 2
    y = conv(x, w, b, p, groups)
    dy = torch.randn(y.shape, generator=torch.Generator().manual_seed(1)).to(dtype)
    got = torch.autograd.grad(y, (x, w, b), dy)
    want = torch.autograd.grad(_plain(x, w, b, p, groups), (x, w, b), dy)
    assert torch.equal(y, _plain(x, w, b, p, groups))
    for g, r in zip(got, want):
        assert g.shape == r.shape and g.dtype == r.dtype
        scale = r.float().abs().max().item()
        assert (g.float() - r.float()).abs().max().item() <= tol * scale


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5), (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("kernel", [4, 5])
def test_torch_weight_norm_conv_backward_matches_plain(dtype, tol, kernel):
    """``WeightNormConv1d``'s gradients of its input, ``weight_g``,
    ``weight_v`` and ``bias`` (fp32 parameters, the conv in ``dtype``)
    against autograd through the same kernel and plain ``F.conv1d``."""
    torch.manual_seed(0)
    m = WeightNormConv1d(16, kernel, 4, dtype=dtype, param_dtype=torch.float32)
    m.init_from(torch.Generator().manual_seed(2))
    with torch.no_grad():
        m.weight_g.uniform_(0.5, 1.5)
        m.bias.normal_()
    x = torch.randn(2, 11, 16).to(dtype).transpose(1, 2).requires_grad_()
    dy = torch.randn(2, 16, 11 + 2 * (kernel // 2) - kernel + 1).to(dtype)
    params = (x, m.weight_g, m.weight_v, m.bias)
    got = torch.autograd.grad(m(x), params, dy)
    plain = F.conv1d(x, m.kernel().to(dtype), m.bias.to(dtype), padding=m.padding,
                     groups=m.groups)
    want = torch.autograd.grad(plain, params, dy)
    for g, r in zip(got, want):
        assert g.shape == r.shape and g.dtype == r.dtype
        scale = r.float().abs().max().item()
        assert (g.float() - r.float()).abs().max().item() <= tol * scale


@CONVS
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_torch_pos_conv_forward_is_conv1d_bit_for_bit(conv, dtype):
    """Under ``no_grad`` and with gradients on, the forward is
    ``F.conv1d``'s to the bit, as is the module's."""
    x, w, b = _operands(2, 8, 9, 6, 2, dtype)
    want = F.conv1d(x.detach(), w.detach(), b.detach(), padding=3, groups=2)
    with torch.no_grad():
        assert torch.equal(conv(x, w, b, 3, 2), want)
    assert torch.equal(conv(x, w, b, 3, 2).detach(), want)
    m = WeightNormConv1d(8, 6, 2, dtype=dtype, param_dtype=torch.float32)
    m.init_from(torch.Generator().manual_seed(3))
    kernel = m.kernel().to(dtype).detach()
    with torch.no_grad():
        out = m(x)
    assert torch.equal(out, F.conv1d(x.detach(), kernel, m.bias.to(dtype).detach(), padding=3,
                                     groups=2))
    assert torch.equal(m(x).detach(), out)


def test_torch_pos_conv_counts_each_input_gradient():
    """``avhubert.pos_conv_input_grad`` adds one per backward pass that
    computes the module's input gradient: none for a forward under
    ``no_grad``, none for an input that needs no gradient, none while no
    recording is open."""
    m = WeightNormConv1d(8, 4, 2, dtype=torch.float32)
    m.init_from(torch.Generator().manual_seed(4))
    x = torch.randn(2, 8, 10, requires_grad=True)
    name = "avhubert.pos_conv_input_grad"
    m(x).sum().backward()  # recording off
    with spans.recording() as rec:
        with torch.no_grad():
            m(x)
        m(x.detach()).sum().backward()
    assert name not in rec.counters
    with spans.recording() as rec:
        m(x).sum().backward()
    assert rec.counters[name] == 1
    with spans.recording() as rec:
        for _ in range(3):
            m(x).square().sum().backward()
    assert rec.counters[name] == 3


# -- on the card -------------------------------------------------------------


@pytest.mark.card
def test_torch_pos_conv_input_grad_on_the_card():
    """AV-HuBERT large's positional conv at the fine-tuning cell's shape:
    the input gradient within bf16 rounding of the fp32 one (TF32 off;
    autograd's through plain ``F.conv1d`` reads about ten times as far
    off), laid out as autograd's, and no
    backward-data kernel (``dgrad_engine``) among the kernels of the
    module's backward."""
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card: cuDNN's engines are picked on the chip")
    from torch.profiler import ProfilerActivity, profile

    dev = "cuda"
    m = WeightNormConv1d(1024, 128, 16, dtype=torch.bfloat16, param_dtype=torch.float32,
                         device=dev)
    m.init_from(torch.Generator(device=dev).manual_seed(5))
    g = torch.Generator(device=dev).manual_seed(6)
    rows = torch.randn(8, 250, 1024, device=dev, generator=g).to(torch.bfloat16)
    dy = torch.randn(8, 1024, 251, device=dev, generator=g).to(torch.bfloat16)
    x = rows.transpose(1, 2).requires_grad_()
    (got,) = torch.autograd.grad(m(x), (x,), dy)
    w, b = m.kernel().to(torch.bfloat16).detach(), m.bias.to(torch.bfloat16).detach()
    (plain,) = torch.autograd.grad(F.conv1d(x, w, b, padding=64, groups=16), (x,), dy)
    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        x32 = x.detach().float().requires_grad_()
        (want,) = torch.autograd.grad(F.conv1d(x32, w.float(), b.float(), padding=64,
                                               groups=16), (x32,), dy.float())
    finally:
        torch.backends.cudnn.allow_tf32 = tf32
    scale = want.abs().max().item()
    gap = (got.float() - want).abs().max().item()
    plain_gap = (plain.float() - want).abs().max().item()
    print(f"input gradient against fp32: worst gap {gap:.4g}, autograd's {plain_gap:.4g}, "
          f"of largest {scale:.4g}")
    assert got.shape == x.shape and got.stride() == plain.stride()
    assert gap <= 2 ** -8 * scale  # bf16's half unit in the last place at the largest entry
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        m(x).backward(dy)
        torch.cuda.synchronize()
    names = {e.name for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA}
    print("backward kernels:", sorted(names))
    assert names and not any("dgrad_engine" in n for n in names)
