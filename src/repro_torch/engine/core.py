"""Port of ``repro/engine/core.py``: :class:`SolverEngine` — matrix in,
best reordering (and solve) out.

The facade composes the registries, the selector pipeline, the
ExecutionPlan builder and cache, and the serving plane behind one object
with one configuration: ``train`` → ``select`` / ``select_batch`` →
``plan`` / ``plan_batch`` → ``solve`` / ``solve_batch`` → ``serve``,
``save`` / ``load`` as bundles
(:class:`~repro_torch.engine.bundle.SelectorBundle`), ``metrics`` and
``stats``. The fingerprint of the fitted model/scaler
versions the plan cache, in memory and on disk: a refit gets a fresh cache
front-end, so a stale plan is never served by a newer model.

``solve_batch`` is the served main path on the card: featurize through the
``csr_stats`` kernels and classify with the forest on the card, build plans
(reorder + symbolic on the host), then the pipelined factor, the device
sweeps and fp64 refinement. ``serve`` is the served plane: a
:class:`~repro_torch.launch.serve_selector.AsyncPlanServer` (the deadline
micro-batching dispatcher) on the engine's builder, optionally behind the
RPC front-end. ``solve_policy`` is the solve tuner's policy
(:mod:`repro_torch.autotune.solve_tuner`): a persisted, tuned record for
this device kind and backend when ``autotune_dir`` holds one (tuned on a
miss when ``autotune_solve`` is on), else the reference's conservative
default (``pad="pow2"``, ``bs=None``); it supplies the bucket pad, panel
and sweep knobs of every solve. The bundle lifecycle (:mod:`repro_torch
.lifecycle`): ``start_shadow`` scores a candidate against the decisions
that ``plan`` and the servers of ``serve`` mirror to it, ``promote`` swaps
the serving bundle through the gate and the registry (``registry``, under
``bundle_dir``), ``rollback`` swaps it back; the plan cache follows the
fingerprint both ways.
"""
from __future__ import annotations

import dataclasses
import threading
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

from .bundle import SelectorBundle
from .config import EngineConfig
from .registry import get_feature_set

__all__ = ["SolverEngine", "EngineError"]


class EngineError(RuntimeError):
    """Engine misuse: untrained access, config/selector mismatch, etc."""


def _dataset_provenance(ds) -> Dict[str, Any]:
    """Plain-data description of a LabeledDataset for bundle schema v2."""
    labels = np.asarray(ds.labels)
    return dict(
        kind=type(ds).__name__,
        n_samples=int(np.asarray(ds.features).shape[0]),
        algorithms=list(ds.algorithms),
        feature_set=getattr(ds, "feature_set", "paper12"),
        groups=sorted(set(getattr(ds, "groups", []))),
        dim_range=[int(np.min(ds.dims)), int(np.max(ds.dims))],
        nnz_range=[int(np.min(ds.nnzs)), int(np.max(ds.nnzs))],
        label_counts={alg: int((labels == i).sum())
                      for i, alg in enumerate(ds.algorithms)},
    )


class SolverEngine:
    """One API for train → select → plan → solve → serve → save/load, and
    for the bundle lifecycle (shadow → promote → rollback).

    Build one from a config and train it, attach an existing fitted
    selector, or load a persisted :class:`SelectorBundle`::

        engine = SolverEngine(EngineConfig())
        engine.train(dataset)
        results = engine.solve_batch(mats, bs)
        engine.save("selector.bundle")
        engine = SolverEngine.load("selector.bundle")
    """

    def __init__(self, config: Optional[EngineConfig] = None,
                 selector=None):
        self.config = config if config is not None else EngineConfig()
        self._selector = None
        self._fingerprint: Optional[str] = None
        self._builder = None
        self._metrics = None  # built on first use (sink config on config)
        self._solve_policy = None  # resolved on first use (may tune once)
        self.last_report: Optional[Dict[str, Any]] = None
        # dataset provenance of the last train() — persisted into bundle
        # schema v2 by save() (None for attach()/load()-built engines)
        self.last_provenance: Optional[Dict[str, Any]] = None
        # bundle lifecycle: the bundle the live selector came from (so a
        # re-registration at the next promote reuses its report card
        # instead of a stale last_report), the shadow evaluator mirroring
        # the serving path, and the registry handle
        self._attached_bundle: Optional[SelectorBundle] = None
        self._shadow = None
        self._registry = None
        self._promote_lock = threading.Lock()
        if selector is not None:
            self.attach(selector)

    # -- selector lifecycle --------------------------------------------------
    @property
    def selector(self):
        if self._selector is None:
            raise EngineError("engine has no trained selector yet — call "
                              "train(dataset), attach(selector), or "
                              "SolverEngine.load(path)")
        return self._selector

    @property
    def is_trained(self) -> bool:
        return self._selector is not None

    def attach(self, selector) -> "SolverEngine":
        """Adopt a fitted ``ReorderSelector`` (feature set must match)."""
        fs = getattr(selector, "feature_set", "paper12")
        if fs != self.config.feature_set:
            raise EngineError(
                f"selector was trained on feature set {fs!r} but the engine "
                f"is configured for {self.config.feature_set!r}")
        self._selector = selector
        self._attached_bundle = None  # promote()/load() re-set it after
        self.refresh_fingerprint()
        return self

    def train(self, dataset, **overrides) -> Dict[str, Any]:
        """Grid-search + refit on a :class:`LabeledDataset`; returns the
        evaluation report. Any ``train_selector`` keyword can be overridden
        per call (e.g. ``grid=...``); the new fit gets a new fingerprint,
        which re-versions the plan cache automatically. Families trained by
        gradient descent fit on the config's ``device``."""
        from ..core.selector import train_selector

        cfg = self.config
        if (cfg.algorithms is not None
                and list(cfg.algorithms) != list(dataset.algorithms)):
            raise EngineError(
                f"config asserts algorithms {list(cfg.algorithms)} but the "
                f"dataset was labeled over {list(dataset.algorithms)} — "
                "relabel the dataset or drop the config assertion")
        kwargs: Dict[str, Any] = dict(
            model_name=cfg.model, scaling=cfg.scaling,
            feature_set=cfg.feature_set, fast=cfg.fast_grids, cv=cfg.cv,
            test_size=cfg.test_size, seed=cfg.seed, device=cfg.device)
        kwargs.update(overrides)
        self._selector, report = train_selector(dataset, **kwargs)
        self.last_report = report
        self.last_provenance = _dataset_provenance(dataset)
        self._attached_bundle = None  # the fit is newer than any bundle
        self.refresh_fingerprint()
        return report

    # -- fingerprint → cache version -----------------------------------------
    @property
    def fingerprint(self) -> Optional[str]:
        """Fingerprint of the fitted (model, scaler, features, algorithms);
        ``None`` while untrained. This exact value versions the plan cache,
        and equals the reference's for the same fitted state."""
        return self._fingerprint

    def refresh_fingerprint(self) -> Optional[str]:
        """Recompute the fingerprint from the live selector and, if it
        changed, drop the cache front-end so it is rebuilt under the new
        version. ``train``/``attach``/``load`` call this; call it yourself
        only after mutating the fitted model out of band."""
        if self._selector is None:
            return None
        fp = SelectorBundle.from_selector(self._selector).fingerprint
        if fp != self._fingerprint:
            self._fingerprint = fp
            self._builder = None  # rebuilt lazily under the new version
        return fp

    @property
    def cache_version(self) -> str:
        if self._fingerprint is None:
            raise EngineError("no fingerprint before training")
        return f"sel-{self._fingerprint[:16]}"

    @property
    def metrics(self):
        """The engine's :class:`repro_torch.core.metrics.MetricsRegistry`,
        shared by the cache tiers, the plan builder, the dispatcher and the
        RPC front-end, so ``metrics.snapshot()`` covers the whole serving
        stack; with ``metrics_jsonl`` set, events also go to that file."""
        if self._metrics is None:
            from ..core.metrics import JSONLSink, MetricsRegistry

            self._metrics = MetricsRegistry()
            if self.config.metrics_jsonl:
                self._metrics.add_sink(JSONLSink(self.config.metrics_jsonl))
        return self._metrics

    def _get_builder(self):
        if self._builder is None:
            from ..core.plan import PlanBuilder
            from ..core.plan_cache import PlanCache, TwoTierPlanCache

            cfg = self.config
            if cfg.cache_dir:
                cache = TwoTierPlanCache(
                    cfg.cache_capacity, cfg.cache_dir,
                    version=self.cache_version,
                    max_disk_bytes=cfg.cache_max_disk_bytes,
                    max_disk_entries=cfg.cache_max_disk_entries,
                    metrics=self.metrics)
            else:
                cache = PlanCache(cfg.cache_capacity, metrics=self.metrics)
            self._builder = PlanBuilder(
                self.selector, cache, path=cfg.path,
                batch_size=cfg.batch_size, device=cfg.device,
                metrics=self.metrics)
        return self._builder

    @property
    def builder(self):
        """The fingerprint-versioned :class:`PlanBuilder` (cache included)."""
        return self._get_builder()

    # -- selection -----------------------------------------------------------
    def select(self, a) -> Tuple[str, float]:
        """(algorithm name, prediction seconds) for one matrix (host)."""
        return self.selector.select(a)

    def select_batch(self, mats: Sequence) -> List[str]:
        """Algorithm names for a batch via the configured path."""
        self._ensure_serving_mesh()
        names, _ = self.selector.select_batch(
            mats, path=self.config.path, device=self.config.device)
        return names

    # -- planning ------------------------------------------------------------
    def _mint(self, ctx):
        from ..core.reqctx import RequestContext

        if ctx is None:
            ctx = RequestContext.mint(
                deadline_ms=self.config.default_deadline_ms)
        return ctx

    def plan(self, a, ctx=None):
        """Cached :class:`ExecutionPlan` for one matrix. Mints a
        :class:`repro_torch.core.reqctx.RequestContext` when the caller
        brought none; either way it gets the spans ``cache`` and, on a miss,
        ``select``, ``reorder`` and ``symbolic``. With a shadow evaluator
        active, the decision is mirrored to it once the plan is in hand."""
        self._ensure_serving_mesh()
        plan, _ = self._get_builder().get_or_build(a, ctx=self._mint(ctx))
        if self._shadow is not None:
            # O(enqueue), never raises: the response is untouched
            self._shadow.observe(a, plan.algorithm, key=plan.fingerprint)
        return plan

    def plan_batch(self, mats: Sequence) -> List:
        """Plans for a request batch (hits skip every cold stage)."""
        self._ensure_serving_mesh()
        return self._get_builder().plan_batch(mats)

    # -- solving -------------------------------------------------------------
    @property
    def solve_policy(self):
        """The :class:`repro_torch.autotune.solve_tuner.SolvePolicy` this
        engine applies to the numeric backends. With ``autotune_solve`` off
        this is the conservative default (kernel defaults, pow2 padding)
        unless a tuned record for this device kind and backend is already
        persisted in ``autotune_dir``; with it on, the first access runs
        the tuner once on the config's device (persisting the result) and
        every later engine just loads it."""
        if self._solve_policy is None:
            from ..autotune.solve_tuner import get_policy

            cfg = self.config
            self._solve_policy = get_policy(
                cfg.autotune_dir, backend=cfg.backend,
                autotune=cfg.autotune_solve, device=cfg.device)
        return self._solve_policy

    def _solve_kwargs(self) -> Dict[str, Any]:
        """The numeric knobs of ``execute_plan``: the config's path and
        the solve policy's pad, panel and sweep knobs."""
        cfg = self.config
        pol = self.solve_policy
        return dict(solver=cfg.solver, backend=cfg.backend,
                    solve_dtype=cfg.solve_dtype, pad=pol.pad, bs=pol.bs,
                    sweep=cfg.sweep, sweep_bs=pol.sweep_bs, rt=pol.rt,
                    device=cfg.device, metrics=self.metrics)

    def solve(self, a, b: Optional[np.ndarray] = None,
              ctx=None) -> Dict[str, Any]:
        """Plan (cached) + numeric factor + solve; returns the result dict
        of :func:`repro_torch.core.plan.execute_plan` (x, timings, spans,
        residual, request id). One
        :class:`~repro_torch.core.reqctx.RequestContext` (minted when the
        caller brought none) spans planning and the numeric tail: its
        deadline is checked between the factorization's levels, and its
        spans land in the engine's metrics as ``stage.*`` histograms. The
        solve policy (``solve_policy``) supplies the bucket pad, panel and
        sweep knobs."""
        from ..core.plan import execute_plan

        ctx = self._mint(ctx)
        return execute_plan(a, self.plan(a, ctx=ctx), b, ctx=ctx,
                            **self._solve_kwargs())

    def solve_batch(self, mats: Sequence,
                    bs: Optional[Sequence[Optional[np.ndarray]]] = None
                    ) -> List[Dict[str, Any]]:
        """``plan_batch`` (one device selection over the misses), then one
        ``execute_plan`` per matrix; ``bs[i]`` is the right-hand side of
        ``mats[i]`` (None: a seeded one)."""
        from ..core.plan import execute_plan

        plans = self.plan_batch(mats)
        if bs is None:
            bs = [None] * len(mats)
        kw = self._solve_kwargs()
        return [execute_plan(a, p, b, **kw)
                for a, p, b in zip(mats, plans, bs)]

    # -- serving -------------------------------------------------------------
    def _ensure_serving_mesh(self) -> None:
        """Install the configured serving mesh (``serving_devices``) if it is
        not already active: process-global, as in the reference, and a
        no-op when the config leaves ``serving_devices`` unset. A mesh of
        another width or on another kind of device is replaced."""
        nd = self.config.serving_devices
        if nd is None:
            return
        from ..device import resolve_device
        from ..distributed.meshctx import (installed_serving_mesh,
                                           make_serving_mesh,
                                           set_serving_mesh)

        kind = resolve_device(self.config.device).type
        cur = installed_serving_mesh()
        if cur is None and nd == 1:
            return  # the degenerate mesh of the device's kind is the default
        if cur is None or cur.num_devices != nd or cur.kind != kind:
            set_serving_mesh(make_serving_mesh(nd, self.config.device))

    def serve(self, *, rpc: bool = False, host: Optional[str] = None,
              port: Optional[int] = None, **overrides):
        """A fresh server bound to this engine's builder (and so to its
        fingerprint-versioned cache).

        ``rpc=False`` returns the in-process
        :class:`~repro_torch.launch.serve_selector.AsyncPlanServer`;
        ``rpc=True`` also binds the socket front-end
        (:class:`~repro_torch.launch.rpc.PlanRPCServer`) on ``(host,
        port)``, defaulting to the config's ``rpc_host``/``rpc_port``, and
        returns it: its ``close()`` shuts the pipeline down too, and the
        bound port is ``server.port``. A failed bind closes the pipeline
        before it raises. Keyword overrides pass through to the pipeline
        (``batch_size``, ``max_wait_ms``, ``build_workers``, ...). The
        dispatcher mirrors every resolved decision to the engine's shadow
        evaluator, read afresh each time, so a ``start_shadow`` or
        ``stop_shadow`` after ``serve`` takes effect at once."""
        from ..launch.serve_selector import AsyncPlanServer

        self._ensure_serving_mesh()
        cfg = self.config
        kwargs = dict(batch_size=cfg.batch_size,
                      max_wait_ms=cfg.max_wait_ms,
                      build_workers=cfg.build_workers,
                      max_queue=cfg.max_queue,
                      default_deadline_ms=cfg.default_deadline_ms,
                      metrics=self.metrics,
                      shadow=lambda: self._shadow)
        kwargs.update(overrides)
        server = AsyncPlanServer(self._get_builder(), **kwargs)
        if not rpc:
            return server
        from ..launch.rpc import PlanRPCServer

        try:
            return PlanRPCServer(
                server, host=cfg.rpc_host if host is None else host,
                port=cfg.rpc_port if port is None else port,
                own_dispatcher=True)
        except BaseException:
            # a failed bind must not leak the running batcher and builders
            server.close()
            raise

    # -- bundle lifecycle: shadow → promote → rollback -----------------------
    @property
    def registry(self):
        """The :class:`repro_torch.lifecycle.registry.BundleRegistry` rooted
        at ``config.bundle_dir`` — the durable side of promote/rollback."""
        if (self._registry is None
                or self._registry.root != self.config.bundle_dir):
            from ..lifecycle.registry import BundleRegistry

            self._registry = BundleRegistry(self.config.bundle_dir)
        return self._registry

    @property
    def shadow(self):
        """The active :class:`repro_torch.lifecycle.shadow.ShadowEvaluator`,
        or None. While set, every ``plan()``/``solve()`` decision (and every
        decision of servers built by ``serve()``) is mirrored to it."""
        return self._shadow

    def start_shadow(self, candidate):
        """Shadow-serve a candidate next to the incumbent.

        ``candidate`` is a :class:`SelectorBundle`, a path to one, or a
        fitted ``ReorderSelector``. Replaces any active shadow. The
        evaluator reports into this engine's metrics (``shadow.*``) and
        its ``stats()`` are the online evidence ``promote()`` gates on."""
        from ..lifecycle.shadow import ShadowEvaluator

        self.stop_shadow()
        self._shadow = ShadowEvaluator(
            candidate, metrics=self.metrics,
            max_queue=self.config.shadow_max_queue)
        return self._shadow

    def stop_shadow(self, timeout: float = 10.0
                    ) -> Optional[Dict[str, Any]]:
        """Detach and stop the shadow evaluator; its final ``stats()``
        (after draining the mirror queue), or None if none was active."""
        shadow, self._shadow = self._shadow, None
        if shadow is None:
            return None
        shadow.drain(timeout)
        shadow.close(timeout)
        return shadow.stats()

    def promote(self, candidate=None, *, gate=None,
                source: Optional[str] = None) -> Dict[str, Any]:
        """Gated atomic swap of the serving bundle.

        ``candidate`` defaults to the bundle the active shadow evaluator
        is scoring. The gate (``PromotionGate.from_config(self.config)``
        unless one is passed) checks the candidate's report card and — if
        the shadow evaluator is scoring this exact candidate — its online
        win rate; :class:`repro_torch.lifecycle.promote.NotPromotable` /
        :class:`GateRejected` abort with nothing changed. On pass: the
        incumbent and the candidate are registered (lineage edge incumbent
        → candidate), the registry's serving pointer moves, the engine
        adopts the candidate, and — via the fingerprint → cache-version
        plumbing — every plan built under the incumbent becomes invisible
        (restored intact by :meth:`rollback`). Returns the gate decision
        extended with ``version``/``previous_version``."""
        from ..lifecycle.promote import PromotionGate, evaluate_gate

        with self._promote_lock:
            shadow = self._shadow
            if candidate is None:
                if shadow is None or shadow.bundle is None:
                    raise EngineError(
                        "promote() has no candidate: pass a SelectorBundle "
                        "(or path), or start_shadow() with a bundle first")
                candidate = shadow.bundle
            elif isinstance(candidate, str):
                candidate = SelectorBundle.load(candidate)
            candidate.validate()
            if gate is None:
                gate = PromotionGate.from_config(self.config)
            shadow_stats = None
            if (shadow is not None and shadow.candidate_fingerprint
                    == candidate.fingerprint):
                shadow.drain(10.0)  # settle the scorecard before gating
                shadow_stats = shadow.stats()
            decision = evaluate_gate(candidate, gate, shadow_stats)

            reg = self.registry
            incumbent = self._current_bundle()
            inc_entry = None
            if incumbent is not None:
                inc_entry = reg.register(incumbent, source="incumbent")
                if reg.serving_version() is None:
                    # first promotion ever: record that the incumbent
                    # *was* serving, so rollback has a target
                    reg.mark_serving(inc_entry["version"])
            cand_entry = reg.register(
                candidate, source=source or "promote",
                parent=None if inc_entry is None else inc_entry["version"])
            entry = reg.mark_serving(cand_entry["version"])
            self._adopt_bundle(candidate)
            self.stop_shadow()
            self.metrics.emit("lifecycle.promote",
                              version=entry["version"],
                              fingerprint=candidate.fingerprint)
            return dict(decision, version=entry["version"],
                        previous_version=(None if inc_entry is None
                                          else inc_entry["version"]))

    def rollback(self) -> Dict[str, Any]:
        """Swap the serving bundle back to the registry's ``previous``
        version. The engine re-adopts that bundle, and the fingerprint →
        cache-version plumbing makes its previously persisted plans
        visible again (nothing was deleted at promote time). Returns the
        restored registry entry."""
        with self._promote_lock:
            entry = self.registry.rollback()
            self._adopt_bundle(self.registry.load(entry["version"]))
            self.metrics.emit("lifecycle.rollback",
                              version=entry["version"],
                              fingerprint=entry["fingerprint"])
            return entry

    def _adopt_bundle(self, bundle: SelectorBundle) -> None:
        """Make ``bundle`` the serving state: sync the capability fields,
        attach its selector (which re-versions the plan cache off the new
        fingerprint), and remember the bundle for later registration."""
        if bundle.feature_set != self.config.feature_set:
            raise EngineError(
                f"bundle was trained on feature set "
                f"{bundle.feature_set!r} but the engine is configured for "
                f"{self.config.feature_set!r}")
        self.config = dataclasses.replace(
            self.config, model=bundle.model_name,
            scaling=bundle.scaler_name, algorithms=list(bundle.algorithms))
        self.attach(bundle.to_selector())
        self._attached_bundle = bundle
        # last_report described the *previous* fit; the adopted bundle's
        # own report card travels with it
        self.last_report = None
        self.last_provenance = None

    # -- persistence ---------------------------------------------------------
    def _report_card(self) -> Optional[Dict[str, Any]]:
        """The schema-v2 report card of the last ``train()``, or None for
        an attach()/load()-built engine (whose quality was not measured
        here)."""
        if self.last_report is None:
            return None
        rep = self.last_report
        conf = rep.get("confusion")
        return dict(
            test_accuracy=rep.get("test_accuracy"),
            cv_score=rep.get("cv_score"),
            best_params=rep.get("best_params"),
            per_algorithm_recall=rep.get("per_algorithm_recall"),
            confusion=(np.asarray(conf).tolist()
                       if conf is not None else None),
            test_support=rep.get("test_support"),
        )

    def _current_bundle(self) -> Optional[SelectorBundle]:
        """The serving state as a bundle: the attached bundle when the live
        selector still matches it (so its report card survives), else a
        fresh snapshot carrying this engine's training report (if any)."""
        if self._selector is None:
            return None
        if (self._attached_bundle is not None
                and self._attached_bundle.fingerprint == self._fingerprint):
            return self._attached_bundle
        return SelectorBundle.from_selector(
            self.selector, report_card=self._report_card(),
            provenance=self.last_provenance)

    def save(self, path: str, meta: Optional[Dict[str, Any]] = None) -> str:
        """Persist the fitted selector as a versioned SelectorBundle.

        When the engine trained the selector itself, the bundle carries the
        schema-v2 training-report card and the dataset provenance; an
        attach()/load()-built engine saves a bundle with both ``None``."""
        meta = dict(meta or {})
        report_card = self._report_card()
        if report_card is not None:
            meta.setdefault("test_accuracy", report_card["test_accuracy"])
        return SelectorBundle.from_selector(
            self.selector, meta=meta, report_card=report_card,
            provenance=self.last_provenance).save(path)

    @classmethod
    def load(cls, path: str, config: Optional[EngineConfig] = None
             ) -> "SolverEngine":
        """Rebuild an engine from a bundle (validating it), adopting the
        bundle's feature set when no config is given. A config whose
        ``feature_set`` disagrees with the bundle is rejected. The
        capability fields (model / scaling / algorithms) are synced to what
        the bundle serves; a passed config contributes the cache, path and
        solve knobs."""
        bundle = SelectorBundle.load(path)
        if config is None:
            config = EngineConfig(feature_set=bundle.feature_set)
        elif config.feature_set != bundle.feature_set:
            raise EngineError(
                f"bundle {path!r} was trained on feature set "
                f"{bundle.feature_set!r} but the engine config asks for "
                f"{config.feature_set!r}")
        config = dataclasses.replace(config, model=bundle.model_name,
                                     scaling=bundle.scaler_name,
                                     algorithms=list(bundle.algorithms))
        engine = cls(config).attach(bundle.to_selector())
        engine._attached_bundle = bundle  # keep its report card for
        return engine                     # registration at promote time

    # -- introspection -------------------------------------------------------
    def feature_set(self):
        return get_feature_set(self.config.feature_set)

    def stats(self) -> Dict[str, Any]:
        s = (self._get_builder().stats() if self._selector is not None
             else {})
        s.update(fingerprint=self._fingerprint,
                 model=self.config.model, scaling=self.config.scaling,
                 feature_set=self.config.feature_set)
        return s

    def __repr__(self) -> str:
        fp = self._fingerprint[:12] if self._fingerprint else "untrained"
        return (f"SolverEngine(model={self.config.model!r}, "
                f"features={self.config.feature_set!r}, fingerprint={fp})")
