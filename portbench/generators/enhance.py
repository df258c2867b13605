"""On-demand enhancement traffic: one client in a closed loop, each request
one already-lifted video of sentence clips, enhanced through the port's
``infer.run_inference`` with the configuration's text conditioning.

Set-up makes ``requests`` distinct videos: the clip counts and lengths are one
fixed multiset drawn from the traffic's own seed (counts uniform over a range,
lengths lognormal and clipped), ordered by ``--seed``; each clip's r6d frames
come from random axis-angles, and each clip has a 512-d text vector.  The
standardization statistics are the benchmark's, from all requests' windows.
A request is timed from its submission until its enhanced windows are on
the host: ``data.windows.make_equal_len`` (cutting+reflect, 192), the
standardization, ``run_inference`` at the traffic's batch, float32, and the
de-standardization.  Its latency is read on the card's clock (CUDA events
recorded on the idle stream before and after it, so it holds the host's work
as well).  Set-up sends one request of every clip count once.  The window
cycles through the requests until ``seconds`` have passed; ``check`` judges
a sample of finished requests drawn from the seed, with the largest among
them.

The end-to-end metric is the card's time a video costs: with ``--trace 0``
the whole window runs under the profiler's device records
(``WINDOW_DEVICE_TRACE``), and the card's busy time is divided by the
videos enhanced.  The latency's 95th percentile, which the host's speed
moves from run to run by more than a bound can hold, is read per layer from
the window of a ``--trace 1`` run, which runs unprofiled.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from multimodal_hand_pose_enhancement_for_sign_language_tpu_torch.data import windows
from multimodal_hand_pose_enhancement_for_sign_language_tpu_torch.infer import run_inference
from multimodal_hand_pose_enhancement_for_sign_language_tpu_torch.models import registry
from portbench.generators import stats
from portbench.generators.lift_enhance import clip_lengths
from portbench.harness import compare, counts
from portbench.reference import convert as ref_convert
from portbench.reference import gan as ref_gan
from portbench.reference import models as ref_models

SPANS = ("request",)
WINDOW_DEVICE_TRACE = True  # run.py: with --trace 0, the window under trace.traced(host=False)


def request_sizes(traffic):
    """The fixed multiset: a list of clip-length arrays, one per request."""
    rng = np.random.RandomState(traffic["sizes_seed"])
    lo, hi = traffic["clips_per_request"]
    n_clips = rng.randint(lo, hi + 1, size=traffic["requests"])
    lengths = clip_lengths(traffic, int(n_clips.sum()))  # from ``lengths_seed``
    return np.split(lengths, np.cumsum(n_clips)[:-1])


class Clock:
    """Request timestamps on the card's clock (CUDA events); on the CPU, the
    host's."""

    def __init__(self, device):
        self.cuda = device.type == "cuda"

    def mark(self):
        if not self.cuda:
            return time.perf_counter()
        e = torch.cuda.Event(enable_timing=True)
        e.record()
        return e

    def seconds(self, a, b):
        return b - a if not self.cuda else a.elapsed_time(b) * 1e-3


class Cell:
    def __init__(self, cfg, traffic, seed, device, rec):
        self.cfg, self.traffic, self.seed, self.rec = cfg, traffic, seed, rec
        self.device = torch.device(device)
        rng = np.random.default_rng(seed)
        gen = torch.Generator(device=self.device).manual_seed(seed)
        self.requests = []
        for lengths in [request_sizes(traffic)[i] for i in rng.permutation(traffic["requests"])]:
            aa = torch.randn((int(lengths.sum()), 144), generator=gen, device=self.device)
            r6d = ref_convert.aa_to_rot6d(traffic["aa_scale"] * aa).cpu().numpy()
            text = torch.randn((len(lengths), 512), generator=gen, device=self.device)
            self.requests.append((np.split(r6d, np.cumsum(lengths)[:-1]), text.cpu().numpy()))
        self.x_cols, self.y_cols = windows.pipeline_column_slices(cfg["pipeline"])
        w = np.concatenate([ref_convert.window_stack(clips) for clips, _ in self.requests])
        self.stats = stats.Standardization(w[:, :, self.x_cols], w[:, :, self.y_cols],
                                           cfg["pipeline"])
        self.model = registry.build_generator(
            cfg["model"], cfg["feature_in_dim"], cfg["feature_out_dim"],
            require_text=cfg["require_text"], default_size=cfg["default_size"],
            dropout_rate=cfg["dropout"], seed=seed, device=self.device)
        self.clock = Clock(self.device)
        done = set()
        for i, (clips, _) in enumerate(self.requests):  # every batch shape once
            if len(clips) not in done:
                done.add(len(clips))
                self.request(i)
        self.sample_rng = np.random.default_rng(seed + 1)
        self.sample, self.largest, self.seen = [], None, 0
        self.marks, self.failed, self.attempted = [], 0, 0
        self.elapsed = None

    def request(self, i):
        clips, text = self.requests[i]
        win = windows.make_equal_len(clips, method="cutting+reflect")
        Xs = self.stats.apply(win[:, :, self.x_cols])
        out, _ = run_inference(self.model, Xs, text, batch_size=self.traffic["batch"],
                               num_samples=len(Xs), device=self.device)
        return self.stats.restore(out)

    def _keep(self, i, out):
        self.failed += int(not np.isfinite(out).all())
        item = (i, out)
        if self.largest is None or len(out) > len(self.largest[1]):
            self.largest = item
        self.seen += 1
        k = self.traffic["sample_requests"]
        if len(self.sample) < k:
            self.sample.append(item)
        else:
            j = self.sample_rng.integers(self.seen)
            if j < k:
                self.sample[j] = item

    def window(self, seconds):
        t0 = time.perf_counter()
        n = 0
        while n == 0 or time.perf_counter() - t0 < seconds:
            i = n % len(self.requests)
            with self.rec.span("request"):
                start = self.clock.mark()
                out = self.request(i)
                self.marks.append((start, self.clock.mark()))
            self._keep(i, out)
            n += 1
        self.elapsed = time.perf_counter() - t0
        self.attempted = n

    def traced_unit(self):
        for i in range(len(self.requests)):
            with self.rec.span("request"):
                self.request(i)
        return {"requests": len(self.requests)}

    def latencies(self):
        if self.clock.cuda:
            torch.cuda.synchronize()
        return [self.clock.seconds(a, b) for a, b in self.marks]

    def end_to_end(self, window_trace=None):
        """The card's busy milliseconds over the window's videos, from the
        window's device records; on the CPU (the tests), which has none, the
        requests' mean time."""
        if window_trace is not None and window_trace.busy_s > 0:
            busy = window_trace.busy_s
        else:
            busy = sum(self.latencies())
        return {"enhance_device_ms_per_video": 1e3 * busy / self.attempted}

    def layer_counts(self):
        """The window's counts: the requests' forward operations, counted
        once the window has closed, and the 95th percentile of its
        latencies."""
        done = np.bincount([len(self.requests[i % len(self.requests)][0])
                            for i in range(self.attempted)])
        flops = sum(int(k) * counts.generator_flops(self.cfg, n, ref_convert.WINDOW_T)
                    for n, k in enumerate(done) if k)
        p95 = 1e3 * float(np.percentile(self.latencies(), 95))
        return {"window_s": self.elapsed, "flops": flops, "request_p95_ms": p95}

    def free(self):
        del self.model

    def evidence(self):
        items = list(self.sample)
        if all(i != self.largest[0] for i, _ in items):
            items.append(self.largest)
        return items

    def check(self):
        return judge(self.cfg, self.seed, self.requests, self.evidence(), self.stats, self.device)


def judge(cfg, seed, requests, items, st, device, dtype=torch.float64):
    """[("output_gap", v)]: over the sampled requests, the largest gap
    between the program's enhanced windows and the plain reference's, in
    ``dtype`` from the same clips and text, over the reference's largest
    output."""
    x_cols = slice(0, cfg["feature_in_dim"])
    net = ref_models.build_generator(cfg, seed, dtype, device)
    got, want = [], []
    with torch.no_grad():
        for i, out in items:
            clips, text = requests[i]
            x = st.apply(ref_convert.window_stack(clips)[:, :, x_cols])
            x = torch.from_numpy(x).to(device, dtype).transpose(1, 2)
            f = torch.from_numpy(text).to(device, dtype)
            y = net(x, f).transpose(1, 2).cpu().numpy()
            want.append(y * st.std_y + st.mean_y)
            got.append(out)
    return [("output_gap", compare.relative_max(np.concatenate(got), np.concatenate(want)))]


def calibrate(cell):
    """The program's reading and the control's: the reference's forward in
    the program's place at float32 with TF32 on, the precision below what
    the configuration states, on the same sampled requests."""
    items = cell.evidence()
    cfg, st, dev = cell.cfg, cell.stats, cell.device
    net = ref_models.build_generator(cfg, cell.seed, torch.float32, dev)
    control = []
    with torch.no_grad(), ref_gan.precision(tf32=True):
        for i, _ in items:
            clips, text = cell.requests[i]
            x = st.apply(ref_convert.window_stack(clips)[:, :, slice(0, cfg["feature_in_dim"])])
            y = net(torch.from_numpy(x).to(dev).transpose(1, 2),
                    torch.from_numpy(text).to(dev)).transpose(1, 2).cpu().numpy()
            control.append((i, st.restore(y)))
    return {"program": judge(cfg, cell.seed, cell.requests, items, st, dev),
            "control": judge(cfg, cell.seed, cell.requests, control, st, dev)}
