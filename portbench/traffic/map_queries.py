"""Loop-closure queries against a keyframe map of binary descriptors.

The map: ``frames`` keyframes x ``slots`` descriptors of ``words`` int32
words, seeded on the device, each keyframe with a seeded number of valid
slots (a prefix). A query is one keyframe's descriptors and valid mask:
a share ``revisit_share`` of the queries revisits a map keyframe (its
rows, each with ``flipped_bits`` distinct bits flipped, and its mask),
the rest are new places (uniform words). Set-up makes one query for each
request a run can send, so none repeats: every seed makes the same
numbers of each kind in another order. One client sends the queries back
to back through ``parallel.matching.sharded_match`` on a (1, 1) mesh, and
reads each query's matches on the host.

The check: a sample of the window's queries drawn from the seed, half
revisits and half new places, each against ``reference.hamming.match``
over the whole map: every field of every row equal.
"""

from __future__ import annotations

import contextlib
import datetime
import math
import socket
import time

import numpy as np
import torch

from portbench.reference import hamming

FIELDS = ("idx", "distance", "second_distance", "mask")


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def random_words(g, n: int, words: int, device) -> torch.Tensor:
    """(n, words) int32 of uniform bits."""
    b = torch.randint(0, 256, (n, 4 * words), dtype=torch.uint8,
                      generator=g, device=device)
    return b.view(torch.int32)


def flip_masks(g, n: int, words: int, flips: int, device) -> torch.Tensor:
    """(n, words) int32 masks, each with `flips` distinct bits set."""
    bits = 32 * words
    pos = torch.rand(n, bits, generator=g, device=device).topk(flips).indices
    m = torch.zeros(n, bits, dtype=torch.uint8, device=device)
    m.scatter_(1, pos, 1)
    weights = (2 ** torch.arange(8, device=device)).to(torch.int32)
    packed = (m.view(n, 4 * words, 8).to(torch.int32) * weights).sum(-1)
    return packed.to(torch.uint8).view(torch.int32)


def prefix_valid(g, n: int, slots: int, least: int, device) -> torch.Tensor:
    """(n, slots) bool: the first c slots of each, c uniform in
    [least, slots]."""
    counts = torch.randint(least, slots + 1, (n,), generator=g,
                           device=device)
    return torch.arange(slots, device=device)[None, :] < counts[:, None]


class Driver:
    def __init__(self, config: dict, params: dict, seed: int, device,
                 seconds: float):
        import torch.distributed as dist

        from matchinglib_poselib_torch.parallel import mesh as pmesh
        from portbench import tracing

        self.device = device
        self.config, self.params, self.seed = config, params, seed
        frames, slots = config["frames"], config["slots"]
        words = config["words"]
        self.rows = frames * slots
        self.units_per_request = 1
        self.setup_split: dict[str, float] = {}
        t0 = time.perf_counter()
        g = torch.Generator(device=device).manual_seed(seed)
        self.map = random_words(g, self.rows, words, device)
        self.map_valid = prefix_valid(
            g, frames, slots, config["least_valid_slots"], device).reshape(-1)

        # one query per request: the warm-up's, the window's at
        # `pool_per_second` (above the rate at which K2a would reach its
        # roofline), and the traced ones (each traced set profiled at most
        # twice TRIES times), so that no query repeats in a run
        pool = (params["warm_requests"]
                + math.ceil(params["pool_per_second"] * seconds)
                + 2 * tracing.TRIES * params["traced_requests"])
        n_rev = int(round(pool * params["revisit_share"]))
        kinds = torch.zeros(pool, dtype=torch.bool)
        kinds[:n_rev] = True
        self.revisit = kinds[torch.randperm(
            pool, generator=torch.Generator().manual_seed(seed))].numpy()
        rev = torch.from_numpy(np.flatnonzero(self.revisit)).to(device)
        new = torch.from_numpy(np.flatnonzero(~self.revisit)).to(device)
        self.queries = torch.empty((pool, slots, words), dtype=torch.int32,
                                   device=device)
        self.query_valid = prefix_valid(g, pool, slots,
                                        config["least_valid_slots"], device)
        src = torch.randint(0, frames, (n_rev,), generator=g, device=device)
        self.query_valid[rev] = self.map_valid.view(frames, slots)[src]
        per = max(1, params["flip_block_rows"] // slots)
        for c in range(0, n_rev, per):
            s = src[c:c + per]
            flips = flip_masks(g, len(s) * slots, words,
                               params["flipped_bits"], device)
            self.queries[rev[c:c + per]] = (
                self.map.view(frames, slots, words)[s]
                ^ flips.view(len(s), slots, words))
        self.queries[new] = random_words(
            g, (pool - n_rev) * slots, words, device).view(-1, slots, words)
        self._split("inputs", t0)

        t0 = time.perf_counter()
        if device.type == "cuda":
            torch.cuda.set_device(device)
        dist.init_process_group(
            "nccl" if device.type == "cuda" else "gloo",
            init_method=f"tcp://127.0.0.1:{_free_port()}", rank=0,
            world_size=1, timeout=datetime.timedelta(seconds=300))
        self.mesh = pmesh.make_mesh(1, device=device)
        self._split("process_group", t0)
        self.results: dict[int, np.ndarray] = {}

    def _split(self, name: str, t0: float) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.setup_split[name] = time.perf_counter() - t0

    def _annotate(self, name: str, traced: bool):
        if not traced:
            return contextlib.nullcontext()
        return torch.profiler.record_function(name)

    def request(self, i: int, traced: bool = False) -> int:
        from matchinglib_poselib_torch.parallel import matching as pmatch

        k = i % len(self.queries)
        with self._annotate("sharded_match", traced):
            res = pmatch.sharded_match(
                self.mesh, self.queries[k], self.map, self.query_valid[k],
                self.map_valid, binary=True, ratio=self.config["ratio"],
                ratio_test=self.config["ratio_test"],
                cross_check=self.config["cross_check"])
        with self._annotate("read matches", traced):
            host = torch.stack([
                res.idx.to(torch.int32), res.distance.view(torch.int32),
                res.second_distance.view(torch.int32),
                res.mask.to(torch.int32)]).cpu().numpy()
        if not traced:
            self.results[i] = host
        return 1

    def warm(self) -> None:
        t0 = time.perf_counter()
        for i in range(self.params["warm_requests"]):
            self.request(i, traced=True)
        self._split("warm", t0)

    def spans_ms(self) -> dict:
        return {}

    def counters(self) -> dict:
        return {}

    def free_program(self) -> None:
        """The program holds nothing but its process group, which the
        reference does not need either."""

    def close(self) -> None:
        import torch.distributed as dist

        if dist.is_initialized():
            dist.destroy_process_group()

    def sample(self) -> list[int]:
        """Window queries to check, drawn from the seed: half revisits,
        half new places (as far as the window has them)."""
        rng = np.random.default_rng([self.seed, 1])
        done = sorted(self.results)
        n = self.params["check_queries"]
        picked = []
        for kind in (True, False):
            pool = [i for i in done
                    if self.revisit[i % len(self.queries)] == kind]
            take = min(len(pool), n // 2 if kind else n - len(picked))
            picked += list(rng.choice(pool, size=take, replace=False))
        return sorted(int(i) for i in picked)

    def answers(self, i: int, bits: int | None = None) -> dict:
        """The reference's answer to window query i."""
        k = i % len(self.queries)
        c = self.config
        return hamming.match(self.queries[k], self.query_valid[k], self.map,
                             self.map_valid, c["ratio"], c["ratio_test"],
                             c["cross_check"], bits=bits)

    @staticmethod
    def differing_rows(host: np.ndarray, ref: dict) -> int:
        got = {"idx": host[0], "distance": host[1].view(np.float32),
               "second_distance": host[2].view(np.float32),
               "mask": host[3].astype(bool)}
        bad = np.zeros(host.shape[1], dtype=bool)
        for f in FIELDS:
            bad |= got[f] != ref[f].cpu().numpy()
        return int(bad.sum())

    def check(self, limits: dict, control: bool = False) -> dict:
        """Every field of every row of the sampled queries against the
        reference. `control` puts the reference in the program's place,
        with distances over the first ``control_bits`` bits only: a cheaper
        distance that breaks the exact 2-NN the configuration states."""
        bad = 0
        for i in self.sample():
            host = self.results[i]
            if control:
                ctl = self.answers(i, bits=self.params["control_bits"])
                host = torch.stack([
                    ctl["idx"], ctl["distance"].view(torch.int32),
                    ctl["second_distance"].view(torch.int32),
                    ctl["mask"].to(torch.int32)]).cpu().numpy()
            bad += self.differing_rows(host, self.answers(i))
        return {"rows_differing": {"value": bad,
                                   "limit": limits["rows_differing"]}}
