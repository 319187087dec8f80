"""A plain 2-D convolution (stride, zero padding; no dilation, no groups)
whose double backward is written out: the discriminator's
(``models/layers.py::DConv``), which the gradient penalty differentiates
twice.

aten's double backward of ``F.conv2d`` (``_convolution_double_backward``)
takes the weight's gradient as a forward convolution on transposed
tensors, ``conv(ggI^T, gO^T)``: its batch is the layer's input channels,
its filter the whole gradient map (Cout, B, H_out, W_out), its output the
k x k kernel. The reduction over B·H·W then falls inside each of
Cin·Cout·k² outputs, and cuDNN runs it with a forward algorithm far below
the card's rate. The same quantity is the layer's weight gradient of
``ggI`` against ``gO``, which ``aten.convolution_backward`` computes with
its weight-gradient engines on the layer's own shapes. Here:

- ``conv2d`` with grad off, or nothing requiring it, is ``F.conv2d``;
- else ``_Conv2d``, whose forward is the same ``F.conv2d``. Its backward
  without ``create_graph`` is the one ``aten.convolution_backward`` that
  autograd's own node makes; with ``create_graph`` it is
  ``_Conv2dBackward``, whose forward is that call and whose backward,
  given the gradients ggI, ggW, ggb of its outputs, returns

      gO:  conv2d(ggI, W) + conv2d(x, ggW) + ggb
      x:   convolution_backward(gO, x, ggW)'s input gradient
      W:   convolution_backward(gO, ggI, W)'s weight gradient

  each term only where its gradient is defined, and is counted as one of
  counter ``conv_dbwd`` (``utils/logging.py``). A third derivative raises.

Each backward computes only the gradients the engine will use, as
autograd's own node does: the gradient penalty's first backward asks for
no weight gradient. It asks the engine of each input's node; a leaf that
requires grad enters through a view, since the engine refuses that
question for a leaf under ``autograd.grad``.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple, Union

import torch
import torch.nn.functional as F
from torch.autograd.function import once_differentiable
from torch.nn.modules.utils import _pair

from histogan_tpu_torch.utils.logging import count

Size2 = Union[int, Sequence[int]]


def _needed(ctx, n: int) -> List[bool]:
    """Whether the engine will use the gradient of each of the first ``n``
    inputs of ``ctx``'s node (an input that is None has no edge: False)."""
    edges = ctx.next_functions[:n]
    return [node is not None and torch._C._will_engine_execute_node(node)
            for node, _ in edges] + [False] * (n - len(edges))


def _enter(t: Optional[torch.Tensor]) -> Optional[torch.Tensor]:
    """``t``, through a view where it is a leaf that requires grad."""
    return t.view_as(t) if t is not None and t.requires_grad and t.grad_fn is None else t


def _convolution_backward(g: torch.Tensor, x: torch.Tensor, w: torch.Tensor,
                          bias: bool, stride: Tuple[int, int], padding: Tuple[int, int],
                          mask: List[bool]) -> Tuple[Optional[torch.Tensor], ...]:
    """(gx, gw, gb) of ``conv2d(x, w, b, stride, padding)`` for output
    gradient ``g``, those that ``mask`` asks for (else None)."""
    return torch.ops.aten.convolution_backward(
        g, x, w, [w.shape[0]] if bias else None, stride, padding, [1, 1], False, [0, 0], 1,
        mask)


class _Conv2d(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, b, stride, padding):
        ctx.set_materialize_grads(False)
        ctx.save_for_backward(x, w)
        ctx.bias, ctx.stride, ctx.padding = b is not None, stride, padding
        return F.conv2d(x, w, b, stride, padding)

    @staticmethod
    def backward(ctx, g):
        if g is None:
            return None, None, None, None, None
        x, w = ctx.saved_tensors
        mask = _needed(ctx, 3)
        if not torch.is_grad_enabled():
            return (*_convolution_backward(g, x, w, ctx.bias, ctx.stride, ctx.padding, mask),
                    None, None)
        return (*_Conv2dBackward.apply(_enter(g), x, w, ctx.bias, ctx.stride, ctx.padding,
                                       mask), None, None)


class _Conv2dBackward(torch.autograd.Function):
    @staticmethod
    def forward(ctx, g, x, w, bias, stride, padding, mask):
        ctx.set_materialize_grads(False)
        ctx.save_for_backward(g, x, w)
        ctx.stride, ctx.padding = stride, padding
        return _convolution_backward(g, x, w, bias, stride, padding, mask)

    @staticmethod
    @once_differentiable
    def backward(ctx, ggx, ggw, ggb):
        count("conv_dbwd")
        g, x, w = ctx.saved_tensors
        stride, padding = ctx.stride, ctx.padding
        need_g, need_x, need_w = _needed(ctx, 3)
        gg = gx = gw = None
        if need_g:
            if ggx is not None:
                gg = F.conv2d(ggx, w, None, stride, padding)
            if ggw is not None:
                t = F.conv2d(x, ggw, None, stride, padding)
                gg = t if gg is None else gg + t
            if ggb is not None:
                t = ggb.reshape(1, -1, 1, 1).expand(g.shape)
                gg = t if gg is None else gg + t
        if need_x and ggw is not None:
            gx = _convolution_backward(g, x, ggw, False, stride, padding,
                                       [True, False, False])[0]
        if need_w and ggx is not None:
            gw = _convolution_backward(g, ggx, w, False, stride, padding,
                                       [False, True, False])[1]
        return gg, gx, gw, None, None, None, None


def conv2d(x: torch.Tensor, weight: torch.Tensor, bias: Optional[torch.Tensor] = None,
           stride: Size2 = 1, padding: Size2 = 0) -> torch.Tensor:
    """``F.conv2d(x, weight, bias, stride, padding)`` whose double backward
    takes the weight gradient from the layer's own weight-gradient
    kernel (module docstring)."""
    if not torch.is_grad_enabled() or not (
            x.requires_grad or weight.requires_grad
            or (bias is not None and bias.requires_grad)):
        return F.conv2d(x, weight, bias, stride, padding)
    return _Conv2d.apply(_enter(x), _enter(weight), _enter(bias), _pair(stride), _pair(padding))
