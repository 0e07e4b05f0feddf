"""Hopper probe of ``scripts/probe_packet.py``: a packet of P rays walks a
synthetic tree with one shared control flow (a stack of node ids in
on-chip memory, every node's row broadcast to all rays, an ``any`` over
the packet deciding the pushes).

Kernel: ``csrc/probe_packet.cu``, one packet per block. The TPU ran one
packet on its one core; the card runs ``copies`` identical packets, one per
block, so a launch with one copy per SM gives one packet's time per visit
(``ns_per_visit``) and the card's rate (``ray_gvisit_per_s`` over all
copies), and every copy's output must be equal.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from ray_tracer_2_tpu_torch.kernels.cuda_build import CudaFunction, \
    check_tensor
from ray_tracer_2_tpu_torch.probes.common import CSRC, kernel, measure, \
    nbytes, on_cuda, probe
from ray_tracer_2_tpu_torch.probes.trav import OPS_TRAV_SLOT, SLOTS, _slab, \
    f32_chain

SOURCE = CSRC / "probe_packet.cu"
PACKET = kernel("packet", CudaFunction(SOURCE, "rt2_probe_packet",
                                       "pippiiippp"),
                "scripts/probe_packet.py:89")
DEPTH = 48
MAX_RAYS = 1024


def packet(nodes, iv, b, *, K: int, copies: int = 1):
    """``run(P, K, N)``'s kernel on its inputs: nodes (N, 128) f32, iv and b
    (P, 128) f32. Returns (the probe's output (copies, P) = tbest +
    visits, the visits (copies,) int32, each ray's hit slots over all
    visits (copies, P) int32)."""
    if not on_cuda(nodes, iv, b):
        return packet_plain(nodes, iv, b, K=K, copies=copies)
    dev, N, P = nodes.device, nodes.shape[0], iv.shape[0]
    check_tensor("nodes", nodes, torch.float32, (N, SLOTS), dev)
    for name, x in (("iv", iv), ("b", b)):
        check_tensor(name, x, torch.float32, (P, SLOTS), dev)
    if not 0 < P <= MAX_RAYS or N < 2:
        raise ValueError(f"packet: 1..{MAX_RAYS} rays and >= 2 nodes, got "
                         f"{P} and {N}")
    out = torch.empty((copies, P), dtype=torch.float32, device=dev)
    visits = torch.empty(copies, dtype=torch.int32, device=dev)
    hits = torch.empty((copies, P), dtype=torch.int32, device=dev)
    PACKET.launch(nodes, N, iv, b, P, K, copies, out, visits, hits)
    return out, visits, hits


def packet_plain(nodes, iv, b, *, K: int, copies: int = 1):
    """The plain PyTorch version of ``packet`` (any device): one packet,
    its result repeated for ``copies``. The stack and its pointer live on
    the host; each visit reads the two ``any`` flags back."""
    N, P = nodes.shape[0], iv.shape[0]
    children = [(max(int(c12) % N, 1), max(int(c13) % N, 1))
                for c12, c13 in nodes[:, 12:14].cpu().tolist()]
    tb = f32_chain(1e9, 0.9995, 0.001, K)
    stack = [0] * DEPTH
    sp, visits = 1, 0
    hits = torch.zeros(P, dtype=torch.int32, device=iv.device)
    while sp > 0 and visits < K:
        node = stack[sp - 1]
        hit = _slab(nodes[node][None], iv, b, tb[visits])
        hits += hit.sum(1, dtype=torch.int32)
        near, far = torch.stack([hit[:, 0].any(), hit[:, 6].any()]).tolist()
        c_near, c_far = children[node]
        sp -= 1
        stack[sp] = c_far
        sp += int(far)
        stack[sp] = c_near
        sp = min(sp + int(near), DEPTH - 1)
        visits += 1
    # tbest + visits in float32, as the kernel adds them
    out = torch.full((copies, P), tb[visits], dtype=torch.float32,
                     device=iv.device) + float(visits)
    return (out, torch.full((copies,), visits, dtype=torch.int32,
                            device=iv.device),
            hits[None].expand(copies, P).contiguous())


def packet_inputs(ctx, P: int, N: int = 16384):
    """``run``'s inputs, drawn as it draws them (``probe_packet.py:85-88``)
    from ``ctx.seed``."""
    rng = ctx.rng()
    nodes = rng.random((N, SLOTS)).astype(np.float32)
    iv = rng.random((P, SLOTS)).astype(np.float32)
    b = rng.random((P, SLOTS)).astype(np.float32)
    return ctx.tensor(nodes), ctx.tensor(iv), ctx.tensor(b)


@probe("packet")
def p_packet(ctx):
    copies = 1
    if ctx.device.type == "cuda":
        copies = torch.cuda.get_device_properties(
            ctx.device).multi_processor_count
    for P, K in ctx.sizes(((8, 4096), (64, 4096), (256, 4096),
                           (1024, 2048))):
        args = packet_inputs(ctx, P)
        fn = functools.partial(packet, K=K, copies=copies)
        visits = int(fn(*args)[1][0])
        measure(ctx, "packet", dict(P=P, K=K), fn, args,
                lambda t: dict(ns_per_visit=t / K * 1e9,
                               mvisit_per_s=K / t / 1e6,
                               ray_gvisit_per_s=copies * P * K / t / 1e9),
                plain=functools.partial(packet_plain, K=K, copies=copies),
                ops=copies * visits * P * SLOTS * OPS_TRAV_SLOT,
                nbytes=nbytes(*args[1:])
                + min(visits, args[0].shape[0]) * SLOTS * 4
                + copies * (P * 8 + 4),
                kernel="packet", iters=5, extra=dict(copies=copies,
                                                     visits=visits))
