"""Gradient checkpointing (remat) with the JAX package's policies.

The JAX DiM wraps each block in `nn.remat` with a policy that names what
the backward replay keeps instead of recomputing (`_remat_policy`,
dimsum_tpu/models/dim.py:134-169): None saves nothing; "dots" every matmul
output; "scan" the selective-scan outputs; "dots_scan" both; "save:A+B"
any of `dots` and the tagged sites `scan_out`, `attn_out` and `conv_out`.
`parse_policy` reads that grammar into the set of things kept, and
`checkpoint` runs one block through `torch.utils.checkpoint` (non-reentrant)
keeping them.

What is kept is kept by one of two mechanisms, because
`torch.utils.checkpoint`'s selective contexts see only dispatcher ops:

  * dispatcher ops: a matmul (`aten.mm`, `addmm`, `bmm`, `baddbmm`) under
    "dots", and every op inside a `tag(name)` region whose name is kept
    (the plain scan, the conv, SDPA and the plain full-block attention),
    are saved by `create_selective_checkpoint_contexts` and handed back on
    replay.  Under "dots" one pair of contexts covers the whole block;
    otherwise each kept region enters a pair of its own, so that the ops
    outside it pass through no Python dispatch mode (which, over a whole
    block, slowed a host-bound DiM-L/2 step 1.7x).  Which sites are tag
    regions on a given device is the ops layer's business alone: a policy
    that keeps only kernel sites puts no op through a mode;
  * the port's kernels, ctypes calls inside `autograd.Function`s that the
    dispatcher never sees: their Function's forward runs the launch through
    `kernel_outputs(name, launch)`, which under a kept name stores the
    launch's outputs (with what the Function saves for its backward) in
    the block's region on the first forward and returns them on replay
    instead of launching again.  Ops inside such a launch are never saved
    by the selective contexts, so the two mechanisms never count the same
    op, and a skipped launch leaves no saved op behind to be handed to the
    wrong caller.

Random draws under remat.  Stochastic depth draws its masks from the
block's explicit `generator`; `torch.utils.checkpoint` restores only the
default generators, so a replay would draw new masks from the advanced
generator and give a wrong gradient without any error.  `checkpoint` takes
the generator, keeps its state from before the block's first forward, sets
it back for the replay, and afterwards restores the state the replay found,
so the draws after the step are those of a run without remat.

Launch counts.  A DiM-L/2 step runs 32 scans (16 blocks, two mixers each).
Under remat each block is replayed once in the backward, so under None,
"dots", "save:attn_out" and "save:conv_out" the scan's training forward
(kernel 2) launches 64 times a step and its backward (kernel 3) 32; under a
policy that keeps `scan_out` ("scan", "dots_scan", "save:...+scan_out")
32 and 32.  Kernel 1 (inference) never launches under grad.  Likewise the
conv + x_proj kernel (`conv_xproj`) launches twice a mixer unless
`conv_out` is kept, and the full-block attention kernel of the combined
blocks' fusion (512 px) twice unless `attn_out` is kept; the shared DiT
block is not checkpointed.
"""

from __future__ import annotations

import contextlib
import functools
import threading
from typing import Callable, FrozenSet, Optional

import torch
from torch.utils.checkpoint import (CheckpointPolicy,
                                    create_selective_checkpoint_contexts)

TAGS = ("scan_out", "attn_out", "conv_out")
_DOTS = (torch.ops.aten.mm, torch.ops.aten.addmm, torch.ops.aten.bmm,
         torch.ops.aten.baddbmm)

_local = threading.local()  # region: the block being run; tag; in_kernel


def parse_policy(name: Optional[str]) -> FrozenSet[str]:
    """What a remat policy keeps, from `dots` and `TAGS` (empty: full
    remat).  Raises `ValueError` on an unknown policy or tag, as the JAX
    `_remat_policy` does."""
    if name in (None, "", "none"):
        return frozenset()
    if name == "dots":
        return frozenset({"dots"})
    if name == "scan":
        return frozenset({"scan_out"})
    if name == "dots_scan":
        return frozenset({"dots", "scan_out"})
    if name.startswith("save:"):
        parts = [p for p in name[len("save:"):].split("+") if p]
        bad = set(parts) - {"dots", *TAGS}
        if not parts or bad:
            raise ValueError(
                f"remat_policy {name!r}: unknown tags {sorted(bad)}; "
                f"compose from 'dots' and {sorted(TAGS)}")
        return frozenset(parts)
    raise ValueError(f"unknown remat_policy {name!r}")


class _Region:
    """One checkpointed call: what it keeps, the kernel outputs kept from
    its first forward, the selective contexts of its kept tag regions, and
    whether it is replaying."""

    def __init__(self, keep: FrozenSet[str]):
        self.keep = keep
        self.whole_block = "dots" in keep  # one pair of contexts for all
        self.outputs = []
        self.tag_contexts = []
        self.calls = 0
        self.replay = False
        self.pos = self.tag_pos = 0

    def tag_context(self):
        """The selective context of the block's next kept tag region: the
        saving one of a new pair in the first forward, the serving one of
        that region's pair on replay."""
        if not self.replay:
            pair = create_selective_checkpoint_contexts(_keep_all)
            self.tag_contexts.append(pair)
            return pair[0]
        self.tag_pos += 1
        return self.tag_contexts[self.tag_pos - 1][1]


def _region() -> Optional[_Region]:
    return getattr(_local, "region", None)


@contextlib.contextmanager
def _set(name: str, value):
    prev = getattr(_local, name, None)
    setattr(_local, name, value)
    try:
        yield
    finally:
        setattr(_local, name, prev)


@contextlib.contextmanager
def tag(name: str):
    """A region of dispatcher ops named `name` (one of `TAGS`): inside a
    checkpointed block whose policy keeps `name`, its ops' outputs are
    saved in the first forward and handed back on replay."""
    region = _region()
    with contextlib.ExitStack() as stack:
        stack.enter_context(_set("tag", name))
        if (region is not None and name in region.keep
                and not region.whole_block):
            stack.enter_context(region.tag_context())
        yield


def kernel_outputs(name: str, launch: Callable):
    """`launch()` at a kernel site named `name`, from inside an autograd
    Function's forward: its outputs (a tensor or a tuple of tensors).  In
    a checkpointed block whose policy keeps `name`, the first forward keeps
    them and the replay returns them without launching."""
    region = _region()
    if region is not None and name in region.keep and region.replay:
        out = region.outputs[region.pos]
        region.pos += 1
        return tuple(t.detach() for t in out) if isinstance(out, tuple) \
            else out.detach()
    with _set("in_kernel", True):
        out = launch()
    if region is not None and name in region.keep:
        region.outputs.append(tuple(t.detach() for t in out)
                              if isinstance(out, tuple) else out.detach())
    return out


def _keep_all(ctx, op, *args, **kwargs):
    """The policy of a kept tag region's own contexts."""
    if getattr(_local, "in_kernel", False):
        return CheckpointPolicy.PREFER_RECOMPUTE
    return CheckpointPolicy.MUST_SAVE


def _policy(ctx, op, *args, **kwargs):
    """The policy of a "dots" block's contexts: matmuls and the kept tag
    regions' ops."""
    region = _region()
    if region is None or getattr(_local, "in_kernel", False):
        return CheckpointPolicy.PREFER_RECOMPUTE
    if getattr(_local, "tag", None) in region.keep or (
            "dots" in region.keep and op.overloadpacket in _DOTS):
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


@contextlib.contextmanager
def replay_rng(generator: Optional[torch.Generator], state):
    """Run a replay with `generator` set to `state` (its state before the
    first forward), then give it back the state the replay found."""
    if generator is None:
        yield
        return
    found = generator.get_state()
    generator.set_state(state)
    try:
        yield
    finally:
        generator.set_state(found)


def checkpoint(fn: Callable, keep: FrozenSet[str], *args,
               generator: Optional[torch.Generator] = None, **kwargs):
    """fn(*args, generator=generator, **kwargs) under non-reentrant
    `torch.utils.checkpoint`: its activations are dropped after the
    forward and recomputed in the backward, except what `keep` (from
    `parse_policy`) names.  `generator` is the explicit generator `fn`
    draws from; its draws are replayed as they were (see the module
    docstring)."""
    region = _Region(keep)
    state = generator.get_state() if generator is not None else None

    def run(*a, **kw):
        region.replay = region.calls > 0
        region.pos = region.tag_pos = 0
        region.calls += 1
        with contextlib.ExitStack() as stack:
            if region.replay:
                stack.enter_context(replay_rng(generator, state))
            stack.enter_context(_set("region", region))
            return fn(*a, generator=generator, **kw)

    context_fn = (functools.partial(create_selective_checkpoint_contexts,
                                    _policy)
                  if region.whole_block else torch.utils.checkpoint.noop_context_fn)
    return torch.utils.checkpoint.checkpoint(
        run, *args, use_reentrant=False, context_fn=context_fn, **kwargs)
