"""The CharResNet's training-mode BatchNorm kernels' wrappers on the CPU:
for CPU tensors they take the plain version (the eager functions of
``ops/resnet.py``, then the ReLU and the tail's add), so the CharResNet with
``use_kernels`` on a CPU tensor is today's, bit for bit: outputs, every
gradient and the running statistics; the wrappers' refusals, which come
before any launch; the thread mapping each BatchNorm of the CharResNets
takes. The kernels themselves run in ``tests/test_torch_cuda.py``."""

import copy

import pytest
import torch

from realise_tpu_torch.ops import resnet as tresnet
from realise_tpu_torch.ops.kernels import batch_norm as kbn
from torch_port_fixtures import one_intra_op_thread


def _bn(c, seed):
    gen = torch.Generator().manual_seed(seed)
    bn = torch.nn.BatchNorm2d(c, eps=tresnet.BN_EPS).train()
    with torch.no_grad():
        bn.weight.normal_(1.0, 0.2, generator=gen)
        bn.bias.normal_(0.0, 0.2, generator=gen)
        bn.running_mean.normal_(0.0, 0.2, generator=gen)
        bn.running_var.uniform_(0.5, 1.5, generator=gen)
    return bn


def _state(module, out, x):
    return ([out, x.grad]
            + [p.grad for p in module.parameters()]
            + [b.clone() for b in module.buffers()])


@pytest.mark.parametrize("weighted", [True, False])
@pytest.mark.parametrize("tail", [False, True])
def test_wrappers_take_the_plain_version_on_the_cpu(tail, weighted):
    """batch_norm_relu and batch_norm_add_relu on CPU tensors: the eager
    chain's bits (``BasicBlock``'s order: the residual branch's
    BatchNorm, then the shortcut's), and no kernel launch counted."""
    gen = torch.Generator().manual_seed(4)
    xs = [torch.randn((5, 6, 4, 4), generator=gen) * 2 + 1
          for _ in range(1 + tail)]
    w = torch.tensor([2.0, 0.0, 1.0, 3.0, 1.0]) if weighted else None
    ct = torch.randn((5, 6, 4, 4), generator=gen)
    runs = []
    for via_wrapper in (True, False):
        bns = torch.nn.ModuleList(_bn(6, 7 + j) for j in range(1 + tail))
        x = [t.clone().requires_grad_(True) for t in xs]
        before = (kbn.bn_train_fwd.launches, kbn.bn_train_bwd.launches)
        if via_wrapper:
            y = (kbn.batch_norm_add_relu(bns[0], x[0], bns[1], x[1], w)
                 if tail else kbn.batch_norm_relu(bns[0], x[0], w))
        elif tail:
            h = tresnet.batch_norm(bns[0], x[0], w)
            y = torch.relu(h + tresnet.batch_norm(bns[1], x[1], w))
        else:
            y = torch.relu(tresnet.batch_norm(bns[0], x[0], w))
        (y * ct).sum().backward()
        assert (kbn.bn_train_fwd.launches,
                kbn.bn_train_bwd.launches) == before
        runs.append(_state(bns, y, x[-1]) + [x[0].grad])
    for a, b in zip(*runs):
        assert torch.equal(a, b)


@pytest.mark.parametrize("weighted", [True, False])
@pytest.mark.parametrize("variant", ["resnet", "resnet1"])
def test_charresnet_with_kernels_is_todays_on_the_cpu(variant, weighted):
    """The training-mode CharResNet (H 48) with ``use_kernels`` on CPU
    tensors against the same module without: features, the glyphs' and
    every parameter's gradient and the running statistics, bit for bit."""
    with one_intra_op_thread():
        torch.manual_seed(0)
        model = tresnet.CharResNet(3, 48, variant).train()
        gen = torch.Generator().manual_seed(1)
        images = torch.rand((7, 3, 32, 32), generator=gen)
        w = torch.tensor([3.0, 0, 1, 2, 5, 0, 1]) if weighted else None
        runs = []
        for use_kernels in (True, False):
            m = copy.deepcopy(model)
            x = images.clone().requires_grad_(True)
            out = m(x, w, use_kernels=use_kernels)
            (out * torch.arange(out.numel()).reshape(out.shape).sin()
             ).sum().backward()
            runs.append(_state(m, out, x))
        for a, b in zip(*runs):
            assert torch.equal(a, b)


def test_eval_mode_ignores_use_kernels():
    """In eval mode the blocks run the running statistics, kernels or not."""
    torch.manual_seed(0)
    model = tresnet.CharResNet(1, 24, "resnet").eval()
    images = torch.rand((3, 1, 32, 32))
    assert torch.equal(model(images, use_kernels=True), model(images))


@pytest.mark.parametrize("case", ["half", "3-D", "contiguous", "x2 shape",
                                  "weights dtype", "weights shape",
                                  "BatchNorm dtype", "no rows",
                                  "BatchNorm count"])
def test_wrappers_refuse_before_any_launch(case):
    """What the kernels do not take raises ValueError before the library
    is loaded: float16, 3-D or non-contiguous x, x2 of another shape,
    float64 or misshapen row weights, a float64 BatchNorm, no rows, inputs
    and BatchNorms of different counts."""
    x = torch.randn((6, 8, 4, 4)).bfloat16()
    w = torch.ones(6)
    bn, bn2 = _bn(8, 0), _bn(8, 1)
    args = {"half": ((x.half(),), (bn,), w),
            "3-D": ((x[0],), (bn,), w),
            "contiguous": ((x.transpose(2, 3),), (bn,), w),
            "x2 shape": ((x, x[:3]), (bn, bn2), w),
            "weights dtype": ((x,), (bn,), w.double()),
            "weights shape": ((x,), (bn,), w[:5]),
            "BatchNorm dtype": ((x,), (_bn(8, 0).double(),), w),
            "no rows": ((x[:0],), (bn,), None),
            "BatchNorm count": ((x, x), (bn,), w)}[case]
    match = {"half": "dtype", "3-D": "3-D", "contiguous": "contiguous",
             "x2 shape": "shape", "weights dtype": "dtype",
             "weights shape": "shape", "BatchNorm dtype": "dtype",
             "no rows": "no rows", "BatchNorm count": "BatchNorms"}[case]
    with pytest.raises(ValueError, match=match):
        kbn.bn_train_fwd(*args)


@pytest.mark.parametrize("dtype, c, hw, want", [
    (torch.bfloat16, 64, 256, 8), (torch.bfloat16, 512, 4, 8),
    (torch.bfloat16, 768, 1, 8), (torch.float32, 768, 1, 4),
    (torch.float32, 128, 64, 4), (torch.bfloat16, 85, 4, 1),
    (torch.float32, 5, 9, 1), (torch.bfloat16, 6, 2, 1)])
def test_thread_mapping_follows_the_shape(dtype, c, hw, want):
    """A 16-byte vector a thread where rows hold whole vectors and a vector
    one channel or whole channels; one element otherwise (85 channels of 4
    bf16 positions: rows of 340 elements; H*W 9; 6 x 2 bf16: 12 elements);
    one element for a misaligned tensor."""
    side = int(hw ** 0.5)
    x = torch.zeros((3, c, side, hw // side), dtype=dtype)
    assert kbn._unit([x], c, hw) == want
    shifted = torch.zeros(x.numel() + 1, dtype=dtype)[1:].view(x.shape)
    assert kbn._unit([x, shifted], c, hw) == 1
