"""AD: operator applies as differentiable functions, in PyTorch.

Counterpart of ``linops_tpu/core/ad.py``. Two paths, as in the reference:

1. **Flow-through.** The plain applies are ordinary torch ops, so
   ``torch.autograd`` and ``torch.func`` differentiate through the operator
   graph with respect to the inputs and to the operators' own tensors. The
   hand-written kernels (K1-K14) write through ctypes into tensors autograd
   cannot see, so every kernel branch that gradients must cross goes through
   ``KernelApply``: its backward is the operator's own adjoint apply (the
   transpose kernel: K1↔K2, K3↔K4, K5↔K6, the routed forward program ↔ its
   transpose, a permutation's stages ↔ the inverse stages) plus, where the
   operator's tensors want gradients, their gradient in plain torch ops.
2. **``apply_linear``**: the reference rule, whose backward is one adjoint
   apply and which gives the operator's tensors no gradient.

Convention. Torch hands a backward the conjugate-Wirtinger cotangent: for a
linear map ``y = A v``, ``torch.autograd.grad(y, v, g)`` is ``Aᴴ g``. So the
pullback mode is ``compose_modes("H", mode)``, where the reference, in
JAX's unconjugated convention, uses ``"T"``. For real dtypes the two agree;
for complex ones torch's gradient is the conjugate of JAX's (for a linear
map, ``grad(y, v, g) = conj(jax_vjp(conj(g)))``).
"""

from __future__ import annotations

import torch

from .base import compose_modes

__all__ = ["apply_linear", "KernelApply", "kernel_graph_wanted"]


class _ApplyLinear(torch.autograd.Function):
    generate_vmap_rule = True

    @staticmethod
    def forward(op, v, mode):
        return op.apply(v, mode)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.op, _, ctx.mode = inputs

    @staticmethod
    def backward(ctx, g):
        # one adjoint apply, itself differentiable (a second derivative works)
        return None, apply_linear(ctx.op, g, compose_modes("H", ctx.mode)), None


def apply_linear(op, v, mode: str = "N"):
    """``op.apply(v, mode)`` whose backward is a single apply in the adjoint
    mode (the reference rrule: the pullback of ``op·x`` is ``op'·ȳ``), with
    no gradient into the operator's tensors. Composes with ``torch.func.grad``
    and ``torch.func.vmap``."""
    return _ApplyLinear.apply(op, v, mode)


def kernel_graph_wanted(*tensors) -> bool:
    """Whether a kernel branch must go through ``KernelApply``: grad mode is
    on and one of ``tensors`` requires grad, or a ``torch.func`` transform
    wraps one of them. Otherwise the branch calls its kernel directly, so
    solver loops under ``no_grad`` pay nothing."""
    grad = torch.is_grad_enabled()
    return any((grad and t.requires_grad) or torch._C._functorch.is_functorch_wrapped_tensor(t)
               for t in tensors)


class KernelApply(torch.autograd.Function):
    """``y = op._kernel_apply(x, how, tensors)``: one kernel branch of an
    operator as an autograd node.

    ``how`` is ``(mode, kind)``: a mode of {N, T, C, H} and the kind of
    apply the operator understands (a vector, a matrix of columns, a row
    panel). ``tensors`` are the operator tensors the apply reads and
    differentiates into (BSR blocks; none for routed and permutation
    applies); the apply must read them from the arguments, not from the
    operator, so that ``gradcheck`` can perturb them.

    Backward: the x-gradient is the same kind of apply in
    ``compose_modes("H", mode)``, through this node again when the graph is
    wanted, so a second derivative works; the tensors' gradients come from
    ``op._kernel_tensor_grads``. Neither falls back to a plain version: a
    kernel that fails raises, forward and backward alike. ``torch.func.vmap``
    over it runs the kernels (``vmap`` below)."""

    @staticmethod
    def forward(op, how, x, *tensors):
        return op._kernel_apply(x, how, tensors)

    @staticmethod
    def setup_context(ctx, inputs, output):
        op, how, x, *tensors = inputs
        ctx.op, ctx.how = op, how
        ctx.save_for_backward(x, *tensors)

    @staticmethod
    def backward(ctx, g):
        x, *tensors = ctx.saved_tensors
        mode, kind = ctx.how
        need_x, need_t = ctx.needs_input_grad[2], ctx.needs_input_grad[3:]
        dx = None
        if need_x:  # through the node again when a second derivative needs the graph
            dx = _node(ctx.op, (compose_modes("H", mode), kind), g, tensors)
        dts = (ctx.op._kernel_tensor_grads(x, g, ctx.how, tensors) if any(need_t)
               else (None,) * len(tensors))
        return (None, None, dx, *dts)

    @staticmethod
    def vmap(info, in_dims, op, how, x, *tensors):
        """A batch of x over unbatched operator tensors runs the operator's
        batched kind where it has one (``op._kernel_batch_kind``, one kind or
        one per mode: a row panel of the B vectors, for every mode of a
        routed operator, for T of a BSR operator), else the kernel once per
        member; batched operator tensors (a batch of operators) run once per
        member. Every member goes through the same kernels as an unbatched
        apply, or its block form."""
        x_dim, t_dims = in_dims[2], in_dims[3:]
        n = info.batch_size
        if x_dim is not None and all(d is None for d in t_dims):
            batch_kind = getattr(op, "_kernel_batch_kind", None)
            if isinstance(batch_kind, dict):
                batch_kind = batch_kind.get(how[0])
            if how[1] == "vec" and batch_kind is not None:
                return _node(op, (how[0], batch_kind), x.movedim(x_dim, 0), tensors), 0
        outs = [_node(op, how, x if x_dim is None else x.select(x_dim, i),
                      tuple(t if d is None else t.select(d, i) for t, d in zip(tensors, t_dims)))
                for i in range(n)]
        return torch.stack(outs), 0


def _node(op, how, x, tensors):
    """One kernel apply: through ``KernelApply`` when the graph is wanted
    (gradients, or a transform still wrapping its inputs), else directly."""
    if kernel_graph_wanted(x, *tensors):
        return KernelApply.apply(op, how, x, *tensors)
    return op._kernel_apply(x, how, tuple(tensors))

