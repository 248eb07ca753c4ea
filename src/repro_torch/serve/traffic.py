"""Open-loop continuous traffic: arrivals, streaming SLOs, replay driver
(the port's copy of ``repro/serve/traffic.py``; numpy and pure Python,
and :func:`make_trace` gives the reference's trace field for field).

Every serving number this repo reported before this module came from a
*closed-loop* replay: all requests enqueued at t=0, throughput measured at
drain.  Closed loops hide exactly the thing the thesis says to measure —
data-handling stalls.  A server under real load sees an *open-loop*
arrival process: requests land on their own schedule whether or not the
engine has capacity, queueing delay compounds, and the user-visible
metrics are latency percentiles, not aggregate tokens/s (DESIGN.md §9).

This module owns the traffic model and the measurement; it knows nothing
about pages or models:

  * :class:`ScenarioProfile` + :func:`make_trace` — seeded mixed-workload
    request generation (chat short-decode, RAG long-prefill shared-prefix,
    agent long-decode, summarization long-prefill) over a Poisson or
    bursty (compound-Poisson) arrival process;
  * :class:`LatencyAccountant` — per-request TTFT (first token minus
    arrival, queueing included) and TPOT (mean inter-token time after the
    first), p50/p99 percentiles, throughput, and *goodput-under-SLO*: the
    completion rate counting only requests that met BOTH the TTFT and
    TPOT targets.  Goodput is the honest open-loop headline — an
    oversubscribed engine still completes requests, but late;
  * :class:`WallClock` / :class:`VirtualClock` — the driver is
    clock-agnostic: benches run wall time, the deterministic replay tests
    (tests/test_torch_traffic.py) run a virtual clock that advances a
    fixed dt per scheduler tick, making an open-loop run exactly
    reproducible;
  * :class:`TrafficDriver` — pumps arrivals into a
    :class:`~repro_torch.serve.scheduler.Scheduler` at their arrival
    times and wires the scheduler's streaming callbacks into the
    accountant.

Tokens reach the accountant at host-sync granularity: with the fused
decode horizon (DESIGN.md §7) the device hands back up to K tokens per
sync, so a request's token timestamps arrive in bursts of ≤ K.  TPOT is
therefore measured as (last - first token time) / (n_tokens - 1) — exact
for the rate a streaming client experiences, agnostic to burst shape.
"""
from __future__ import annotations

import dataclasses
import time
from collections import deque
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

# --------------------------------------------------------------------------
# scenario profiles (the mixed workload of ROADMAP item 4)
# --------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class ScenarioProfile:
    """One request archetype: ranges are inclusive, token counts are in
    smoke-model scale (the bench/launcher may scale them).  A non-zero
    ``shared_prefix`` prepends that many tokens of a per-profile system
    prompt to every request of the profile — the prefix cache's food."""
    name: str
    weight: float
    prompt_len: Tuple[int, int]
    max_new: Tuple[int, int]
    shared_prefix: int = 0


#: chat: short prompt, short-to-medium decode — the latency-sensitive bulk
CHAT = ScenarioProfile("chat", 4.0, (2, 6), (6, 12))
#: RAG: long prefill dominated by a shared system/context prefix
RAG = ScenarioProfile("rag", 2.0, (8, 16), (3, 6), shared_prefix=16)
#: agent: short prompt, long decode — the decode-horizon regime
AGENT = ScenarioProfile("agent", 1.0, (2, 4), (16, 32))
#: summarization: long prefill, medium decode (the recurrent-stack sweet
#: spot: O(1) state however long the document)
SUMMARIZE = ScenarioProfile("summarize", 1.0, (12, 20), (6, 10))

MIXED_PROFILES: Tuple[ScenarioProfile, ...] = (CHAT, RAG, AGENT, SUMMARIZE)

#: long-document ingestion: the prompt dominates, decode is short — on a
#: unified engine these monopolize prefill chunks and inflate everyone
#: else's TTFT; on the disagg topology they live on the prefill engine
LONGDOC = ScenarioProfile("longdoc", 5.0, (16, 28), (4, 8))

#: the disagg bench mix (DESIGN.md §11): long-prompt-heavy ingestion
#: interleaved with long decoders (agent) and latency-sensitive chat —
#: the regime where splitting prefill from decode pays
DISAGG_PROFILES: Tuple[ScenarioProfile, ...] = (LONGDOC, AGENT, CHAT)


@dataclasses.dataclass(frozen=True)
class TimedRequest:
    rid: int
    profile: str
    prompt: List[int]
    max_new: int
    t_arrival: float


def poisson_arrivals(n: int, rate: float,
                     rng: np.random.Generator) -> np.ndarray:
    """Arrival times of a homogeneous Poisson process: exponential gaps at
    ``rate`` requests/sec."""
    assert rate > 0
    return np.cumsum(rng.exponential(1.0 / rate, size=n))


def bursty_arrivals(n: int, rate: float, rng: np.random.Generator,
                    burst_mean: float = 4.0) -> np.ndarray:
    """Compound-Poisson bursts: burst epochs are Poisson, each epoch lands
    a geometric-sized batch simultaneously (mean ``burst_mean``), and the
    epoch rate is scaled so the *long-run* request rate stays ``rate`` —
    same offered load as :func:`poisson_arrivals`, far spikier."""
    assert rate > 0 and burst_mean >= 1.0
    times: List[float] = []
    t = 0.0
    while len(times) < n:
        t += float(rng.exponential(burst_mean / rate))
        k = int(rng.geometric(1.0 / burst_mean))
        times.extend([t] * min(k, n - len(times)))
    return np.asarray(times[:n])


def make_trace(vocab: int, n_requests: int, rate: float, seed: int,
               process: str = "poisson",
               profiles: Sequence[ScenarioProfile] = MIXED_PROFILES,
               max_prompt: int = 0, max_new_cap: int = 0
               ) -> List[TimedRequest]:
    """Seeded mixed-profile open-loop trace.  Same (seed, shape) args →
    identical trace, byte for byte: the replay tests depend on it.
    ``max_prompt``/``max_new_cap`` clip request sizes so any trace can be
    made to fit a small test pool."""
    assert process in ("poisson", "bursty")
    rng = np.random.default_rng(seed)
    arrive = (poisson_arrivals if process == "poisson"
              else bursty_arrivals)(n_requests, rate, rng)
    w = np.asarray([p.weight for p in profiles], np.float64)
    picks = rng.choice(len(profiles), size=n_requests, p=w / w.sum())
    # one system prompt per profile, shared by all its requests
    system = {p.name: rng.integers(0, vocab, p.shared_prefix).tolist()
              for p in profiles}
    trace = []
    for rid in range(n_requests):
        p = profiles[picks[rid]]
        plen = int(rng.integers(p.prompt_len[0], p.prompt_len[1] + 1))
        mnew = int(rng.integers(p.max_new[0], p.max_new[1] + 1))
        prompt = system[p.name] + rng.integers(0, vocab, plen).tolist()
        if max_prompt:
            prompt = prompt[:max_prompt]
        if max_new_cap:
            mnew = min(mnew, max_new_cap)
        trace.append(TimedRequest(rid, p.name, prompt, mnew,
                                  float(arrive[rid])))
    return trace


# --------------------------------------------------------------------------
# latency accounting: TTFT / TPOT percentiles + goodput-under-SLO
# --------------------------------------------------------------------------
# the percentile rule lives in serve/telemetry.py now (one implementation
# for every latency number the stack reports); re-exported here because
# the SLO tests and benches read it from this module
from .telemetry import Histogram, MetricsRegistry, percentile  # noqa: E402,F401


@dataclasses.dataclass
class _ReqTiming:
    t_arrival: float
    t_first: Optional[float] = None
    t_last: Optional[float] = None
    n_tokens: int = 0
    t_finish: Optional[float] = None
    t_shed: Optional[float] = None      # load-shed by the fault ladder

    @property
    def ttft(self) -> float:
        return self.t_first - self.t_arrival

    @property
    def tpot(self) -> float:
        """Mean inter-token time past the first token; 0 for single-token
        responses (no decode interval exists to violate a TPOT SLO)."""
        if self.n_tokens <= 1:
            return 0.0
        return (self.t_last - self.t_first) / (self.n_tokens - 1)


class LatencyAccountant:
    """Collects per-request arrival/token/finish timestamps and reduces
    them to the open-loop serving metrics (DESIGN.md §9).

    *Throughput* counts every completed request; *goodput* counts only
    requests meeting BOTH SLOs — the spread between them is the cost of
    queueing the closed-loop benches could never see."""

    def __init__(self, metrics: Optional[MetricsRegistry] = None) -> None:
        self.reqs: Dict[int, _ReqTiming] = {}
        # streaming TTFT/TPOT samples feed the shared histogram type
        # (serve/telemetry.py): a TTFT is final at the first token, a TPOT
        # at finish — so the registry's view is live, not summary-time
        m = metrics if metrics is not None else MetricsRegistry()
        self.metrics = m
        self.ttft_hist = m.histogram("traffic.ttft_s")
        self.tpot_hist = m.histogram("traffic.tpot_s")

    def on_arrival(self, rid: int, t: float) -> None:
        assert rid not in self.reqs
        self.reqs[rid] = _ReqTiming(t_arrival=t)

    def on_tokens(self, rid: int, t: float, n: int = 1) -> None:
        if n <= 0:
            return
        r = self.reqs[rid]
        if r.t_first is None:
            r.t_first = t
            self.ttft_hist.observe(r.ttft)
        r.t_last = t
        r.n_tokens += n

    def on_finish(self, rid: int, t: float) -> None:
        r = self.reqs[rid]
        r.t_finish = t
        if r.t_first is not None:
            self.tpot_hist.observe(r.tpot)

    def on_shed(self, rid: int, t: float) -> None:
        """The request was load-shed by the degradation ladder
        (DESIGN.md §12): it never finishes, and the summary reports it —
        a shed is an accounted loss, never a silent one."""
        self.reqs[rid].t_shed = t

    def summary(self, slo_ttft: float = float("inf"),
                slo_tpot: float = float("inf")) -> Dict[str, float]:
        done = [r for r in self.reqs.values()
                if r.t_finish is not None and r.t_first is not None]
        if not done:
            return {"n_finished": 0}
        t0 = min(r.t_arrival for r in self.reqs.values())
        t1 = max(r.t_finish for r in done)
        dur = max(t1 - t0, 1e-9)
        # the summary reduces over *finished* requests only, so it builds
        # its own histograms rather than reading the streaming ones (which
        # may hold first-token samples of still-running requests)
        ttfts, tpots = Histogram(), Histogram()
        ttfts.observe_many(r.ttft for r in done)
        tpots.observe_many(r.tpot for r in done)
        good = [r for r in done
                if r.ttft <= slo_ttft and r.tpot <= slo_tpot]
        return {
            "n_finished": len(done),
            "duration_s": dur,
            "throughput_req_s": len(done) / dur,
            "throughput_tok_s": sum(r.n_tokens for r in done) / dur,
            "ttft_p50": ttfts.percentile(50), "ttft_p99":
                ttfts.percentile(99), "ttft_mean": ttfts.mean,
            "tpot_p50": tpots.percentile(50), "tpot_p99":
                tpots.percentile(99), "tpot_mean": tpots.mean,
            "slo_ttft": slo_ttft, "slo_tpot": slo_tpot,
            "slo_attainment": len(good) / len(done),
            "goodput_req_s": len(good) / dur,
            "n_shed": sum(1 for r in self.reqs.values()
                          if r.t_shed is not None),
        }


def make_slo_shed_policy(acct: LatencyAccountant, clock,
                         slo_ttft: float) -> Callable:
    """SLO-aware shed ordering for the scheduler's degradation ladder
    (DESIGN.md §12): when the ladder must drop a queued request, drop the
    one goodput loses least by — prefer a request that has produced no
    token yet AND whose TTFT SLO is already most blown (it was going to
    miss anyway); among untarnished candidates, the longest-waiting one
    (most at risk).  Requests the accountant never saw (can't happen
    under the driver, but the policy is defensive) rank last."""
    def policy(queued):
        def keyf(req):
            r = acct.reqs.get(req.rid)
            if r is None:
                return (-1, 0.0)
            waited = clock.now() - r.t_arrival
            no_token = r.t_first is None
            # (tier, waited): tier 2 = no token AND SLO already blown,
            # tier 1 = no token yet, tier 0 = already streaming
            tier = 2 if (no_token and waited > slo_ttft) else \
                (1 if no_token else 0)
            return (tier, waited)
        return max(queued, key=keyf)
    return policy


# --------------------------------------------------------------------------
# clocks: wall for benches, virtual for deterministic replay
# --------------------------------------------------------------------------
class WallClock:
    def __init__(self) -> None:
        self._t0 = time.perf_counter()

    def now(self) -> float:
        return time.perf_counter() - self._t0

    def tick(self) -> None:                      # time passes by itself
        pass

    def wait_until(self, t: float) -> None:
        dt = t - self.now()
        if dt > 0:
            time.sleep(dt)


class VirtualClock:
    """Deterministic stand-in: advances ``dt`` per scheduler tick, jumps
    over idle gaps.  Two runs of the same seeded trace therefore see the
    *identical* interleaving of arrivals and ticks — what makes the
    open-loop replay test bit-reproducible."""

    def __init__(self, dt: float = 1.0) -> None:
        self.t = 0.0
        self.dt = dt

    def now(self) -> float:
        return self.t

    def tick(self) -> None:
        self.t += self.dt

    def wait_until(self, t: float) -> None:
        self.t = max(self.t, t)


# --------------------------------------------------------------------------
# the open-loop driver
# --------------------------------------------------------------------------
class TrafficDriver:
    """Run a scheduler against a timed trace, open-loop: a request joins
    the queue when its arrival time passes, never when the engine is
    ready for it.  Streaming token/finish callbacks are timestamped into
    the accountant; with the double-buffered scheduler (``overlap=True``)
    the arrival pump and admission staging for horizon N+1 happen while
    the device is still running horizon N.

    Any object with the scheduler duck type works, the two-engine
    :class:`~repro_torch.serve.disagg.DisaggScheduler` too (its ``step``
    ticks both engines once).  The driver sleeps only while ``queue`` and
    ``slots`` are both empty, and the scheduler then holds no horizon in
    flight (it dispatches one only for occupied slots), so a wall-clock
    sleep never hides device work."""

    def __init__(self, sched, trace: Sequence[TimedRequest],
                 clock=None, accountant: Optional[LatencyAccountant] = None,
                 slo_ttft: Optional[float] = None):
        self.sched = sched
        self.trace = sorted(trace, key=lambda r: (r.t_arrival, r.rid))
        self.clock = clock if clock is not None else WallClock()
        self.acct = accountant if accountant is not None \
            else LatencyAccountant()
        sched.on_tokens = self._on_tokens
        sched.on_finish = self._on_finish
        # fault-plane wiring (DESIGN.md §12): sheds are timestamped into
        # the accountant, and — given a TTFT SLO — the scheduler's ladder
        # picks its shed victims SLO-aware so goodput loses least
        if hasattr(sched, "on_shed"):
            sched.on_shed = self._on_shed
            if slo_ttft is not None:
                sched.shed_policy = make_slo_shed_policy(
                    self.acct, self.clock, slo_ttft)

    def _on_tokens(self, req, n_new: int) -> None:
        self.acct.on_tokens(req.rid, self.clock.now(), n_new)

    def _on_finish(self, req) -> None:
        self.acct.on_finish(req.rid, self.clock.now())

    def _on_shed(self, req) -> None:
        self.acct.on_shed(req.rid, self.clock.now())

    def run(self, max_steps: int = 1_000_000):
        """Drain the trace; returns the scheduler's finished requests."""
        pending = deque(self.trace)
        sched = self.sched
        for _ in range(max_steps):
            t = self.clock.now()
            while pending and pending[0].t_arrival <= t:
                tr = pending.popleft()
                # TTFT is measured from the *intended* arrival: if the
                # driver pumps late (tick granularity), that lag is real
                # queueing delay and must show up in the percentiles
                self.acct.on_arrival(tr.rid, tr.t_arrival)
                sched.add_request(tr.prompt, tr.max_new, rid=tr.rid)
            if not sched.queue and not sched.slots:
                if not pending:
                    break
                # idle: jump (virtual) / sleep (wall) to the next arrival
                self.clock.wait_until(pending[0].t_arrival)
                continue
            sched.step()
            self.clock.tick()
        else:
            raise RuntimeError(f"traffic run exceeded {max_steps} steps")
        assert not sched.queue and not sched.slots
        return sched.finished
