"""The device list that shards run on (counterpart of
`sgnerf_tpu/parallel/mesh.py`).

The JAX package runs one controller over a `jax.sharding.Mesh`; the
reference split rays with `nn.DataParallel` in one process. The port keeps
that shape: a `ShardGroup` is an explicit list of `torch.device`s, one per
shard, and one host thread launches every shard's work one after another,
each kernel under its inputs' device guard and on that device's current
stream. A device may repeat: `[cuda:0, cuda:0]` is two shards on one card
and `[cpu] * 4` four CPU shards, as the JAX tests' virtual devices are.
Nothing here synchronises the host (no `.item()`, `.cpu()` or `nonzero`),
so shards on distinct cards can overlap.

  * `replicate` hands each shard the tensor on its device (the same tensor
    where the device is the source's); autograd's transpose sums the
    shards' cotangents in shard order onto the source: the psum of the
    gradient all-reduce, deterministic.
  * `copies` does the same without a gradient, and keeps the copies on
    other devices while the source lives unmodified, so a grid or an eval
    table crosses to another card once, not every chunk.
  * `psum` sums per-shard tensors, moved to one device, in shard order.
  * `split_rays` / `cat_rays` cut and join the ray axis (axis 1 of
    (B,R,...) tensors): contiguous blocks, the first ones a ray longer
    when the count does not divide.
"""
from __future__ import annotations

import dataclasses
import weakref
from typing import Any, Dict, List, Sequence

import torch


def _expand(dev) -> torch.device:
    """A CUDA device without an index means the current card."""
    dev = torch.device(dev)
    if dev.type == "cuda" and dev.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return dev


class _Replicate(torch.autograd.Function):
    """t -> one tensor per shard device; the backward sums the shards'
    cotangents, moved to t's device, in shard order."""

    @staticmethod
    def forward(ctx, src, devices, t):
        ctx.src = src
        return tuple(t.view_as(t) if d == src else t.to(d) for d in devices)

    @staticmethod
    def backward(ctx, *grads):
        total = None
        for g in grads:
            if g is None:
                continue
            g = g.to(ctx.src)
            total = g if total is None else total + g
        return None, None, total


class ShardGroup:
    """One torch.device per shard; shard 0's is the master device, where
    the inputs come from and the merged outputs go."""

    def __init__(self, devices: Sequence):
        if not devices:
            raise ValueError("a ShardGroup needs at least one device")
        self.devices: List[torch.device] = [_expand(d) for d in devices]
        self._cache: Dict[int, Any] = {}

    @property
    def size(self) -> int:
        return len(self.devices)

    @property
    def master(self) -> torch.device:
        return self.devices[0]

    def __repr__(self):
        return f"ShardGroup({[str(d) for d in self.devices]})"

    # ------------------------------------------------------------- tensors

    def replicate(self, t: torch.Tensor) -> List[torch.Tensor]:
        """Differentiable: t on every shard's device."""
        src = _expand(t.device)
        if t.requires_grad and torch.is_grad_enabled():
            return list(_Replicate.apply(src, tuple(self.devices), t))
        return self.copies(t)

    def copies(self, t: torch.Tensor) -> List[torch.Tensor]:
        """t on every shard's device, without a gradient. A copy to another
        device is kept while t lives and is not modified in place (its
        version counter)."""
        src = _expand(t.device)
        if all(d == src for d in self.devices):
            return [t.detach()] * self.size
        try:
            version = t._version
        except RuntimeError:          # an inference tensor: no counter
            version = None
        key = id(t)
        hit = self._cache.get(key)
        if (version is not None and hit is not None and hit[0]() is t
                and hit[1] == version):
            return hit[2]
        per = {}
        for d in self.devices:
            if d not in per:
                per[d] = t.detach() if d == src else t.detach().to(d)
        out = [per[d] for d in self.devices]
        if version is not None:
            cache = self._cache
            self._cache[key] = (
                weakref.ref(t, lambda _, k=key: cache.pop(k, None)),
                version, out)
        return out

    def replicate_tree(self, tree, grad: bool = True) -> List[Any]:
        """replicate (or copies) mapped over a dict / list / tuple /
        dataclass of tensors -> one tree per shard."""
        def go(x):
            if torch.is_tensor(x):
                return self.replicate(x) if grad else self.copies(x)
            if isinstance(x, dict):
                parts = {k: go(v) for k, v in x.items()}
                return [{k: v[i] for k, v in parts.items()}
                        for i in range(self.size)]
            if isinstance(x, (list, tuple)):
                parts = [go(v) for v in x]
                return [type(x)(p[i] for p in parts)
                        for i in range(self.size)]
            if dataclasses.is_dataclass(x) and not isinstance(x, type):
                parts = {f.name: go(getattr(x, f.name))
                         for f in dataclasses.fields(x)}
                return [dataclasses.replace(
                    x, **{k: v[i] for k, v in parts.items()})
                    for i in range(self.size)]
            return [x] * self.size
        return go(tree)

    def psum(self, tensors: Sequence[torch.Tensor]) -> torch.Tensor:
        """The sum of per-shard tensors on the master, in shard order."""
        total = None
        for t in tensors:
            t = t.to(self.master)
            total = t if total is None else total + t
        return total

    # ------------------------------------------------------------ ray axis

    def ray_slices(self, R: int) -> List[slice]:
        """Contiguous blocks of R rays, one per shard."""
        n = self.size
        base, extra = divmod(R, n)
        out, s = [], 0
        for i in range(n):
            w = base + (1 if i < extra else 0)
            out.append(slice(s, s + w))
            s += w
        return out

    def split_rays(self, t: torch.Tensor) -> List[torch.Tensor]:
        """t's ray axis (axis 1 of (B,R,...)) cut into one block per shard,
        each on its shard's device (differentiable)."""
        return [t[:, sl].to(d)
                for sl, d in zip(self.ray_slices(t.shape[1]), self.devices)]

    def cat_rays(self, parts: Sequence[torch.Tensor]) -> torch.Tensor:
        """Per-shard blocks joined along the ray axis on the master."""
        return torch.cat([p.to(self.master) for p in parts], dim=1)
