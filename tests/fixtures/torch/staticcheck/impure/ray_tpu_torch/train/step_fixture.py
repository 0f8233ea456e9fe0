"""Fixture: captured code (torch.compile, torch.jit.trace, a CUDA graph
capture) that reads the wall clock and the host RNG and forces host
syncs, plus an unbracketed and a bracketed sync outside it."""

import random
import time

import torch


@torch.compile(mode="reduce-overhead")
def step(params, batch):
    started = time.time()  # seeded violation: wallclock-in-jit
    loss = (params * batch).sum()
    return loss, loss.item(), started  # seeded violation: host-sync-in-jit


def noisy(x):
    return x * random.random()  # seeded violation: rng-in-jit


traced = torch.jit.trace(noisy, (torch.ones(2),))


def replay(graph, static_in):
    with torch.cuda.graph(graph):
        out = static_in * 2
        out.cpu()  # seeded violation: host-sync-in-jit
    return out


def train_loop(gp, params, batch):
    with gp.step() as st:
        with st.phase("compute"):
            loss = step(params, batch)[0].item()  # bracketed: silent
    torch.cuda.synchronize()  # seeded violation: unbracketed sync
    return loss
