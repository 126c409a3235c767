"""Port of ``ray_tpu/_private/metrics_view.py``.

Label-aware Prometheus parsing + per-library metric views.

The scrape side (`_private/metrics.py`) renders registries to exposition
text; this module is the READ side: parse that text back into labeled
samples and fold them into the Serve/Data/Train summaries the dashboard
views, `ray_tpu_torch summary serve|data|train`, and
`util.state.summarize_serve/data/train` all render (reference: the
dashboard's metrics module queries Prometheus for the ray_serve_*/
ray_data_* series; here the views aggregate the scrape directly so no
Prometheus server is required).

Dependency-free on purpose: the dashboard is a pure GCS/nodelet client and
must not import the driver-side worker module.
"""

from __future__ import annotations

from typing import Dict, Iterable, List, Optional, Sequence, Tuple

# (metric_name, labels, value)
Sample = Tuple[str, Dict[str, str], float]


def parse_prometheus(text: str) -> List[Sample]:
    """Parse exposition text into labeled samples (inverse of
    Registry.prometheus_text; label values are unescaped)."""
    out: List[Sample] = []
    for line in text.splitlines():
        line = line.strip()
        if not line or line.startswith("#"):
            continue
        try:
            body, value_s = line.rsplit(None, 1)
            value = float(value_s)
        except ValueError:
            continue
        if "{" in body:
            name, _, rest = body.partition("{")
            labels = _parse_labels(rest.rstrip().rstrip("}"))
        else:
            name, labels = body, {}
        out.append((name, labels, value))
    return out


def _parse_labels(s: str) -> Dict[str, str]:
    out: Dict[str, str] = {}
    i = 0
    n = len(s)
    while i < n:
        eq = s.find("=", i)
        if eq < 0 or eq + 1 >= n or s[eq + 1] != '"':
            break  # malformed tail; keep what parsed
        key = s[i:eq].strip().strip(",").strip()
        buf: List[str] = []
        k = eq + 2
        while k < n:
            c = s[k]
            if c == "\\" and k + 1 < n:
                nxt = s[k + 1]
                buf.append({"n": "\n"}.get(nxt, nxt))
                k += 2
                continue
            if c == '"':
                break
            buf.append(c)
            k += 1
        out[key] = "".join(buf)
        i = k + 1
        while i < n and s[i] in ", ":
            i += 1
    return out


def collect_samples(texts: Iterable[str],
                    exclude_sources: Sequence[str] = ()) -> List[Sample]:
    """Parse several scrape documents into one sample list.  A process's
    series appear on its nodelet's scrape tagged ``source=<proc>``;
    ``exclude_sources`` drops those copies so a caller that ALSO reads its
    own local registry (util.state does) never double counts itself."""
    excl = set(exclude_sources)
    out: List[Sample] = []
    for text in texts:
        for name, labels, value in parse_prometheus(text or ""):
            if excl and labels.get("source") in excl:
                continue
            out.append((name, labels, value))
    return out


# --------------------------------------------------------- fold helpers

_Key = Tuple[str, ...]


def _sum_by(samples: List[Sample], name: str,
            keys: Sequence[str]) -> Dict[_Key, float]:
    out: Dict[_Key, float] = {}
    for n, labels, v in samples:
        if n != name:
            continue
        k = tuple(labels.get(x, "") for x in keys)
        out[k] = out.get(k, 0.0) + v
    return out


def _max_by(samples: List[Sample], name: str,
            keys: Sequence[str]) -> Dict[_Key, float]:
    out: Dict[_Key, float] = {}
    for n, labels, v in samples:
        if n != name:
            continue
        k = tuple(labels.get(x, "") for x in keys)
        out[k] = max(out.get(k, v), v)
    return out


def _hist_by(samples: List[Sample], name: str,
             keys: Sequence[str]) -> Dict[_Key, Dict[str, float]]:
    """Fold a histogram's _bucket/_sum/_count series into per-key stats with
    bucket-interpolated percentiles: {key: {count, sum, mean, p50, p95,
    p99}}.  Series from several sources merge by summing buckets first."""
    buckets: Dict[_Key, Dict[float, float]] = {}
    sums = _sum_by(samples, name + "_sum", keys)
    counts = _sum_by(samples, name + "_count", keys)
    for n, labels, v in samples:
        if n != name + "_bucket":
            continue
        le_s = labels.get("le", "+Inf")
        le = float("inf") if le_s == "+Inf" else float(le_s)
        k = tuple(labels.get(x, "") for x in keys)
        per = buckets.setdefault(k, {})
        per[le] = per.get(le, 0.0) + v
    out: Dict[_Key, Dict[str, float]] = {}
    for k, count in counts.items():
        total = sums.get(k, 0.0)
        stats = {
            "count": count,
            "sum": total,
            "mean": (total / count) if count else 0.0,
        }
        per = buckets.get(k, {})
        for q in (0.5, 0.95, 0.99):
            stats[f"p{int(q * 100)}"] = _bucket_quantile(per, count, q)
        out[k] = stats
    return out


def _bucket_quantile(buckets: Dict[float, float], count: float,
                     q: float) -> float:
    """Prometheus-style histogram_quantile: linear interpolation inside the
    first bucket whose cumulative count crosses the target rank."""
    if not buckets or count <= 0:
        return 0.0
    target = q * count
    prev_le, prev_cum = 0.0, 0.0
    for le in sorted(buckets):
        cum = buckets[le]
        if cum >= target:
            if le == float("inf"):
                return prev_le  # open-ended top bucket: best known bound
            span = cum - prev_cum
            frac = ((target - prev_cum) / span) if span > 0 else 1.0
            return prev_le + (le - prev_le) * frac
        prev_le, prev_cum = le, cum
    return prev_le


def _joined(keys: Iterable[_Key]) -> List[Tuple[str, _Key]]:
    return sorted(("/".join(k), k) for k in keys)


# ------------------------------------------------------------ serve view

def summarize_serve(samples: List[Sample]) -> Dict[str, Dict[str, float]]:
    """Per-deployment Serve view: {"app/deployment": {replicas, target,
    requests, errors, queue_depth, latency mean/p50/p95/p99 (s)}}."""
    keys = ("app", "deployment")
    req = _sum_by(samples, "ray_tpu_serve_request_total", keys)
    err = _sum_by(samples, "ray_tpu_serve_request_error_total", keys)
    queue = _sum_by(samples, "ray_tpu_serve_replica_queue_depth", keys)
    reps = _max_by(samples, "ray_tpu_serve_deployment_replicas", keys)
    target = _max_by(samples, "ray_tpu_serve_deployment_target_replicas", keys)
    lat = _hist_by(samples, "ray_tpu_serve_request_latency_seconds", keys)
    out: Dict[str, Dict[str, float]] = {}
    for joined, k in _joined(set(req) | set(err) | set(queue) | set(reps)
                             | set(target) | set(lat)):
        stats = lat.get(k, {})
        out[joined] = {
            "replicas": reps.get(k, 0.0),
            "target_replicas": target.get(k, 0.0),
            "requests": req.get(k, 0.0),
            "errors": err.get(k, 0.0),
            "queue_depth": queue.get(k, 0.0),
            "latency_mean_s": stats.get("mean", 0.0),
            "latency_p50_s": stats.get("p50", 0.0),
            "latency_p95_s": stats.get("p95", 0.0),
            "latency_p99_s": stats.get("p99", 0.0),
        }
    return out


# ------------------------------------------------------------- data view

def summarize_data(samples: List[Sample]) -> Dict[str, Dict]:
    """Data view: per-operator counters/queues plus per-pipeline byte budget
    state: {"operators": {"dataset/op": {...}}, "pipelines": {dataset:
    {buffered_bytes, backpressure}}}."""
    keys = ("dataset", "operator")
    rows = _sum_by(samples, "ray_tpu_data_rows_output_total", keys)
    blocks = _sum_by(samples, "ray_tpu_data_blocks_output_total", keys)
    tasks = _sum_by(samples, "ray_tpu_data_tasks_launched_total", keys)
    queue = _sum_by(samples, "ray_tpu_data_output_queue_blocks", keys)
    operators: Dict[str, Dict[str, float]] = {}
    for joined, k in _joined(set(rows) | set(blocks) | set(tasks)
                             | set(queue)):
        operators[joined] = {
            "rows": rows.get(k, 0.0),
            "blocks": blocks.get(k, 0.0),
            "tasks": tasks.get(k, 0.0),
            "output_queue_blocks": queue.get(k, 0.0),
        }
    buffered = _max_by(samples, "ray_tpu_data_buffered_bytes", ("dataset",))
    gated = _max_by(samples, "ray_tpu_data_backpressure", ("dataset",))
    pipelines = {
        k[0]: {"buffered_bytes": buffered.get(k, 0.0),
               "backpressure": gated.get(k, 0.0)}
        for k in set(buffered) | set(gated)
    }
    return {"operators": operators, "pipelines": pipelines}


# ------------------------------------------------------------ train view

# Values of the ray_tpu_train_gang_state gauge.
GANG_STATES = {"STARTING": 0.0, "RUNNING": 1.0, "FINISHED": 2.0,
               "FAILED": 3.0}
_GANG_NAMES = {v: k for k, v in GANG_STATES.items()}


def summarize_train(samples: List[Sample]) -> Dict[str, Dict]:
    """Per-experiment Train view: gang state/size, report()
    throughput counters, checkpoint-persist latency stats."""
    keys = ("experiment",)
    reports = _sum_by(samples, "ray_tpu_train_report_total", keys)
    rounds = _sum_by(samples, "ray_tpu_train_report_rounds_total", keys)
    state = _max_by(samples, "ray_tpu_train_gang_state", keys)
    workers = _max_by(samples, "ray_tpu_train_gang_workers", keys)
    skew = _max_by(samples, "ray_tpu_train_gang_step_skew", keys)
    ckpt = _hist_by(samples, "ray_tpu_train_checkpoint_persist_seconds", keys)
    # per-rank step heartbeats: derive skew directly from the rank gauges
    # too, so the view names stragglers even before (or without) the
    # driver-folded skew gauge landing on a scrape
    rank_steps = _max_by(samples, "ray_tpu_train_rank_step",
                         ("experiment", "rank"))
    steps_per_exp: Dict[_Key, List[float]] = {}
    for (exp, _rank), v in rank_steps.items():
        steps_per_exp.setdefault((exp,), []).append(v)
    out: Dict[str, Dict] = {}
    for k in set(reports) | set(rounds) | set(state) | set(workers) \
            | set(ckpt) | set(skew) | set(steps_per_exp):
        stats = ckpt.get(k, {})
        steps = steps_per_exp.get(k, [])
        derived_skew = (max(steps) - min(steps)) if len(steps) > 1 else 0.0
        out[k[0]] = {
            "gang_state": _GANG_NAMES.get(state.get(k, -1.0), "UNKNOWN"),
            "workers": workers.get(k, 0.0),
            "reports": reports.get(k, 0.0),
            "report_rounds": rounds.get(k, 0.0),
            "step": max(steps) if steps else 0.0,
            "step_skew": max(skew.get(k, 0.0), derived_skew),
            "checkpoints": stats.get("count", 0.0),
            "checkpoint_mean_s": stats.get("mean", 0.0),
            "checkpoint_p50_s": stats.get("p50", 0.0),
            "checkpoint_p95_s": stats.get("p95", 0.0),
        }
    return out


# ------------------------------------------------------------- llm view

def summarize_llm(samples: List[Sample]) -> Dict[str, Dict[str, float]]:
    """Per-engine LLM view: request/token counters, TTFT and inter-token
    latency percentiles, decode-batch occupancy, KV-page utilization,
    preemptions, queue depth and throughput — the serving-side signals the
    continuous-batching engine exports (ray_tpu_llm_* series)."""
    keys = ("engine",)
    req = _sum_by(samples, "ray_tpu_llm_requests_total", keys)
    ptoks = _sum_by(samples, "ray_tpu_llm_prompt_tokens_total", keys)
    toks = _sum_by(samples, "ray_tpu_llm_tokens_generated_total", keys)
    preempt = _sum_by(samples, "ray_tpu_llm_preemptions_total", keys)
    queue = _sum_by(samples, "ray_tpu_llm_queue_depth", keys)
    running = _sum_by(samples, "ray_tpu_llm_running_requests", keys)
    util = _max_by(samples, "ray_tpu_llm_kv_page_utilization", keys)
    tps = _max_by(samples, "ray_tpu_llm_tokens_per_second", keys)
    ttft = _hist_by(samples, "ray_tpu_llm_ttft_seconds", keys)
    itl = _hist_by(samples, "ray_tpu_llm_inter_token_seconds", keys)
    batch = _hist_by(samples, "ray_tpu_llm_decode_batch_size", keys)
    prefill = _sum_by(samples, "ray_tpu_llm_prefill_tokens_total", keys)
    hits = _sum_by(samples, "ray_tpu_llm_prefix_cache_hit_tokens_total",
                   keys)
    ppages = _max_by(samples, "ray_tpu_llm_prefix_cache_pages", keys)
    # shed carries a reason label; fold it away for the per-engine total
    shed = _sum_by(samples, "ray_tpu_llm_shed_total", keys)
    qwait = _hist_by(samples, "ray_tpu_llm_queue_wait_seconds", keys)
    out: Dict[str, Dict[str, float]] = {}
    for joined, k in _joined(set(req) | set(toks) | set(ptoks) | set(queue)
                             | set(running) | set(util) | set(tps)
                             | set(preempt) | set(ttft) | set(itl)
                             | set(batch) | set(prefill) | set(hits)
                             | set(ppages) | set(shed) | set(qwait)):
        t = ttft.get(k, {})
        i = itl.get(k, {})
        b = batch.get(k, {})
        q = qwait.get(k, {})
        pf = prefill.get(k, 0.0)
        hit = hits.get(k, 0.0)
        out[joined] = {
            "requests": req.get(k, 0.0),
            "prompt_tokens": ptoks.get(k, 0.0),
            "generated_tokens": toks.get(k, 0.0),
            "tokens_per_second": tps.get(k, 0.0),
            "ttft_mean_s": t.get("mean", 0.0),
            "ttft_p50_s": t.get("p50", 0.0),
            "ttft_p95_s": t.get("p95", 0.0),
            "ttft_p99_s": t.get("p99", 0.0),
            "itl_p50_s": i.get("p50", 0.0),
            "itl_p95_s": i.get("p95", 0.0),
            "itl_p99_s": i.get("p99", 0.0),
            "decode_batch_mean": b.get("mean", 0.0),
            "kv_page_utilization": util.get(k, 0.0),
            "preemptions": preempt.get(k, 0.0),
            "queue_depth": queue.get(k, 0.0),
            "running": running.get(k, 0.0),
            "prefill_tokens": pf,
            "prefix_hit_tokens": hit,
            "prefix_hit_rate": hit / (hit + pf) if (hit + pf) > 0 else 0.0,
            "prefix_cache_pages": ppages.get(k, 0.0),
            "shed": shed.get(k, 0.0),
            "queue_wait_p50_s": q.get("p50", 0.0),
            "queue_wait_p95_s": q.get("p95", 0.0),
        }
    return out


# ------------------------------------------------------------ rllib view

def summarize_rllib(samples: List[Sample]) -> Dict[str, Dict[str, float]]:
    """Per-job Podracer RL view: env-step/fragment throughput counters,
    fragment staleness (policy versions behind at consumption), learner
    update + gradient-allreduce latency, Sebulba inference-pool batch
    occupancy, published weight version and env-runner respawns
    (ray_tpu_rllib_* series)."""
    keys = ("job",)
    steps = _sum_by(samples, "ray_tpu_rllib_env_steps_total", keys)
    frags = _sum_by(samples, "ray_tpu_rllib_fragments_total", keys)
    infer_req = _sum_by(samples, "ray_tpu_rllib_inference_requests_total",
                        keys)
    restarts = _sum_by(samples, "ray_tpu_rllib_runner_restarts_total", keys)
    version = _max_by(samples, "ray_tpu_rllib_weight_version", keys)
    stale = _hist_by(samples, "ray_tpu_rllib_fragment_staleness", keys)
    upd = _hist_by(samples, "ray_tpu_rllib_learner_update_seconds", keys)
    ar = _hist_by(samples, "ray_tpu_rllib_learner_allreduce_seconds", keys)
    batch = _hist_by(samples, "ray_tpu_rllib_inference_batch_size", keys)
    out: Dict[str, Dict[str, float]] = {}
    for joined, k in _joined(set(steps) | set(frags) | set(infer_req)
                             | set(restarts) | set(version) | set(stale)
                             | set(upd) | set(ar) | set(batch)):
        s = stale.get(k, {})
        u = upd.get(k, {})
        a = ar.get(k, {})
        b = batch.get(k, {})
        out[joined] = {
            "env_steps": steps.get(k, 0.0),
            "fragments": frags.get(k, 0.0),
            "weight_version": version.get(k, 0.0),
            "staleness_mean": s.get("mean", 0.0),
            "staleness_p50": s.get("p50", 0.0),
            "staleness_p95": s.get("p95", 0.0),
            "updates": u.get("count", 0.0),
            "update_mean_s": u.get("mean", 0.0),
            "update_p95_s": u.get("p95", 0.0),
            "allreduce_mean_s": a.get("mean", 0.0),
            "allreduce_p95_s": a.get("p95", 0.0),
            "inference_requests": infer_req.get(k, 0.0),
            "inference_batch_mean": b.get("mean", 0.0),
            "inference_batch_p95": b.get("p95", 0.0),
            "runner_restarts": restarts.get(k, 0.0),
        }
    return out


# --------------------------------------------------- dashboard history

def history_point(samples: List[Sample]) -> Dict[str, Dict]:
    """Compact per-scrape library snapshot for the dashboard ring buffer —
    only the fields the page turns into sparklines (cumulative counters are
    recorded raw; the page differentiates successive samples into rates)."""
    serve = {
        k: {"requests": v["requests"], "queue": v["queue_depth"],
            "replicas": v["replicas"]}
        for k, v in summarize_serve(samples).items()
    }
    data = {
        k: {"rows": v["rows"], "queue": v["output_queue_blocks"]}
        for k, v in summarize_data(samples)["operators"].items()
    }
    train = {
        k: {"reports": v["reports"], "workers": v["workers"]}
        for k, v in summarize_train(samples).items()
    }
    llm = {
        k: {"tokens": v["generated_tokens"], "queue": v["queue_depth"],
            "running": v["running"]}
        for k, v in summarize_llm(samples).items()
    }
    rllib = {
        k: {"env_steps": v["env_steps"], "fragments": v["fragments"],
            "version": v["weight_version"]}
        for k, v in summarize_rllib(samples).items()
    }
    return {"serve": serve, "data": data, "train": train, "llm": llm,
            "rllib": rllib}
