"""Fault-tolerant checkpointing of the full multi-task manager state (a
port of ``repro.checkpoint.store``, with the same on-disk format).

- one atomic snapshot = manifest.json + per-task .npz blobs, written to a
  temp dir then os.rename'd into place (crash-safe: a half-written snapshot
  is never visible);
- replacing an existing snapshot of the same tag renames the old one ASIDE
  first and deletes it only after the new payload + LATEST pointer are both
  published, so a crash anywhere in the publish leaves one recoverable copy;
- snapshots hold host numpy trees keyed by tree path ("layers/attn_q/a"):
  the port's tensors (on the card or the CPU) are copied to host on save
  (``repro_torch.bridge.to_numpy``, dtype kept: AdamW's ``step`` stays
  int32), and ``load_checkpoint`` gives numpy trees back, which
  ``MARLaaSRuntime.adopt_checkpoint`` puts on its device. The format is the
  JAX package's, so a snapshot written by either package loads in the
  other;
- MARLaaS's strict on-policy invariant makes recovery exact: every task
  resumes at its last committed (θ_t^(v), φ_t^(v)); in-flight rollouts of
  uncommitted versions are regenerated;
- trainer-visible work survives restart on both paths: the sync FIFO buffer
  and the async per-tenant completed-episode queues serialize too, with
  popped-but-uncommitted in-flight items at their queue head (the order
  ``recover_inflight`` restores). Partial GRPO groups do not serialize:
  their rounds are re-issued and regenerate them exactly;
- ``latest_checkpoint`` trusts the LATEST pointer first, and falls back to
  scanning for the newest snapshot with a parseable manifest when LATEST is
  missing, dangling, or points at a torn (manifest-less) directory.

``episodes.pkl`` pickles the queued ``EpisodeGroup``s and their
``RolloutCompletion`` rows (list and numpy leaves, never tensors) under the
writer's module paths. ``load_checkpoint`` reads it with an unpickler that
maps the JAX package's two classes onto the port's copies and refuses every
other class outside builtins, ``collections``, ``types.SimpleNamespace`` and
numpy arrays, so loading a JAX snapshot imports nothing of the JAX package.

The whole payload is written while the manager lock (``mgr._mgr_lock``) is
held, as in the JAX package, so the trainer's snapshot after a commit also
holds up the rollout thread's manager calls for as long.
"""
from __future__ import annotations

import dataclasses
import io
import json
import os
import pickle
import shutil
import tempfile
import time
from collections import deque
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from repro_torch.bridge import to_numpy
from repro_torch.core.chaos import ChaosError
from repro_torch.core.manager import (EpisodeGroup, MultiTaskManager,
                                      TaskSpec, TaskState)
from repro_torch.rl.types import RolloutCompletion, TrajectoryBatch

_SEP = "/"

# per-task fault/drop counters that round-trip through the manifest (the
# conservation invariant must hold ACROSS a restart, not just within one
# incarnation)
_TASK_COUNTERS = ("rollout_rows_total", "stale_rows_dropped", "failed_rows",
                  "quarantine_dropped_rows")
_MGR_COUNTERS = ("stale_rows_dropped", "stale_groups_dropped",
                 "stale_batches_dropped", "discarded_tail_rows",
                 "failed_rows", "quarantine_dropped_rows", "rows_trained",
                 "orphaned_rows")


def tree_to_flat(tree, prefix="") -> Dict[str, np.ndarray]:
    out: Dict[str, np.ndarray] = {}
    if isinstance(tree, dict):
        for k, v in tree.items():
            out.update(tree_to_flat(v, f"{prefix}{k}{_SEP}"))
    elif tree is None:
        pass
    elif isinstance(tree, torch.Tensor):
        out[prefix.rstrip(_SEP)] = to_numpy(tree)
    else:
        out[prefix.rstrip(_SEP)] = np.asarray(tree)
    return out


def flat_to_tree(flat: Dict[str, np.ndarray]):
    tree: Dict[str, Any] = {}
    for key, val in flat.items():
        parts = key.split(_SEP)
        node = tree
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = val
    return tree


def _strip_env(comp):
    """Episodes serialize without their env handle (envs hold RNGs/sessions
    that don't pickle); `MultiTaskManager.rebind_episode_envs` re-attaches
    live handles on load."""
    if dataclasses.is_dataclass(comp) and getattr(comp, "env", None) is not None:
        return dataclasses.replace(comp, env=None)
    return comp


# classes an episodes.pkl may hold, by the writer's module path: the JAX
# package's map onto the port's copies
_EPISODE_CLASSES = {
    ("repro.core.manager", "EpisodeGroup"): EpisodeGroup,
    ("repro.rl.types", "RolloutCompletion"): RolloutCompletion,
    ("repro_torch.core.manager", "EpisodeGroup"): EpisodeGroup,
    ("repro_torch.rl.types", "RolloutCompletion"): RolloutCompletion,
}
_BUILTINS = frozenset({"list", "dict", "tuple", "set", "frozenset", "int",
                       "float", "complex", "str", "bytes", "bytearray",
                       "bool", "slice", "range"})


_NUMPY_MODULES = frozenset({"numpy", "numpy.core.multiarray",
                            "numpy._core.multiarray", "numpy.core.numeric",
                            "numpy._core.numeric"})
_NUMPY_NAMES = frozenset({"ndarray", "dtype", "_reconstruct", "scalar",
                          "_frombuffer"})


class _EpisodeUnpickler(pickle.Unpickler):
    """Reads an episodes.pkl of either package without importing the JAX
    package: its ``EpisodeGroup``/``RolloutCompletion`` become the port's,
    and any other class outside builtins, ``collections``,
    ``types.SimpleNamespace`` and numpy arrays is refused."""

    def find_class(self, module, name):
        cls = _EPISODE_CLASSES.get((module, name))
        if cls is not None:
            return cls
        if (module == "builtins" and name in _BUILTINS) or (
                module == "collections" and name in ("deque", "OrderedDict")
        ) or (module == "types" and name == "SimpleNamespace"):
            return super().find_class(module, name)
        if module in _NUMPY_MODULES and name in _NUMPY_NAMES:
            return super().find_class(module, name)
        raise pickle.UnpicklingError(
            f"episodes.pkl: class {module}.{name} is not an episode record")


def load_episodes(data: bytes):
    """The payload of an episodes.pkl (``{task_id: [EpisodeGroup]}``)."""
    return _EpisodeUnpickler(io.BytesIO(data)).load()


def save_checkpoint(directory: str, mgr: MultiTaskManager,
                    step_tag: Optional[str] = None, *,
                    keep_last_n: int = 0, chaos=None) -> str:
    """Atomic snapshot; returns the snapshot path.

    `keep_last_n` > 0 prunes older snapshots after a successful publish
    (the one just written always survives). `chaos` is the runtime's
    ChaosInjector: the `torn_checkpoint` site simulates a crash mid-publish
    (payload landed, manifest torn, LATEST never moved)."""
    tag = step_tag or f"step_{mgr.total_steps_done():08d}"
    os.makedirs(directory, exist_ok=True)
    tmp = tempfile.mkdtemp(prefix=".ckpt_tmp_", dir=directory)
    manifest = _write_payload(tmp, mgr, tag)
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
    final = os.path.join(directory, tag)
    aside = None
    if os.path.exists(final):
        # rename the old snapshot ASIDE instead of rmtree-ing it: a crash
        # anywhere in the publish below still leaves one recoverable copy
        aside = final + ".replacing"
        if os.path.exists(aside):
            shutil.rmtree(aside)
        os.rename(final, aside)
    os.rename(tmp, final)                      # atomic publish
    if chaos is not None and chaos.fire("torn_checkpoint"):
        # simulate dying mid-publish: payload landed but the manifest is
        # torn and LATEST never moved — recovery must fall back to the
        # previous snapshot via the manifest scan
        os.remove(os.path.join(final, "manifest.json"))
        raise ChaosError("torn checkpoint publish (injected)")
    _write_latest(directory, tag)
    if aside is not None:
        shutil.rmtree(aside)
    if keep_last_n > 0:
        _prune(directory, keep_last_n)
    return final


def _write_payload(tmp: str, mgr: MultiTaskManager, tag: str) -> Dict:
    """Write every task's trees and both trainer feeds into `tmp` under the
    manager lock; returns the manifest (the part of a save that holds the
    lock)."""
    manifest: Dict[str, Any] = {"tag": tag, "time": time.time(), "tasks": {},
                                "buffer": []}
    with mgr._mgr_lock:
        for tid, st in mgr.tasks.items():
            entry = {
                "spec": dataclasses.asdict(st.spec),
                "version": st.version,
                "steps_done": st.steps_done,
                "status": st.status,
                "abandoned": st.abandoned,
                "reward_history": st.reward_history,
                "counters": {k: getattr(st, k) for k in _TASK_COUNTERS},
                "has_adapters": st.adapters is not None,
                "has_opt": st.opt_state is not None,
            }
            if st.adapters is not None:
                np.savez(os.path.join(tmp, f"{tid}_adapters.npz"),
                         **tree_to_flat(st.adapters))
            if st.opt_state is not None:
                np.savez(os.path.join(tmp, f"{tid}_opt.npz"),
                         **tree_to_flat(st.opt_state))
            manifest["tasks"][tid] = entry
        # trainer feed, in recover_inflight order: popped-but-uncommitted
        # work first (it restores to the queue head), then the queues
        batches: List[TrajectoryBatch] = [
            item[2] for item in mgr._inflight_train if item[0] == "batch"]
        batches.extend(mgr.q_buffer)
        for i, tb in enumerate(batches):
            np.savez(os.path.join(tmp, f"buffer_{i}.npz"),
                     tokens=tb.tokens, prompt_lens=tb.prompt_lens,
                     total_lens=tb.total_lens, rewards=tb.rewards,
                     behavior=(tb.behavior_logprobs
                               if tb.behavior_logprobs is not None
                               else np.zeros((0,))),
                     loss_mask=tb.meta.get("loss_mask", np.zeros((0,))))
            manifest["buffer"].append({
                "task_id": tb.task_id, "version": tb.version,
                "group_size": tb.group_size, "idx": i,
            })
        # async feed (event-driven trainer): complete GRPO groups per
        # tenant, in-flight first. Partial groups regenerate — their round
        # re-issues on load via rollout_issued_version = version - 1.
        episodes: Dict[str, List[EpisodeGroup]] = {}
        for item in mgr._inflight_train:
            if item[0] == "episodes":
                episodes.setdefault(item[1], []).extend(item[2])
        for tid, dq in mgr.episodes.items():
            episodes.setdefault(tid, []).extend(dq)
        if episodes:
            payload = {
                tid: [EpisodeGroup(task_id=g.task_id, version=g.version,
                                   rows=[_strip_env(c) for c in g.rows],
                                   seq=g.seq)
                      for g in groups]
                for tid, groups in episodes.items()}
            with open(os.path.join(tmp, "episodes.pkl"), "wb") as f:
                pickle.dump(payload, f)
        manifest["async"] = {
            "counters": {k: getattr(mgr, k) for k in _MGR_COUNTERS},
            "ep_seq": mgr._ep_seq,
            "has_episodes": bool(episodes),
        }
    return manifest


def _write_latest(directory: str, tag: str):
    tmp = os.path.join(directory, ".latest_tmp")
    with open(tmp, "w") as f:
        f.write(tag)
    os.rename(tmp, os.path.join(directory, "LATEST"))


def _manifest_time(path: str) -> Optional[float]:
    """Publish time of a COMPLETE snapshot dir; None if torn/not one."""
    try:
        with open(os.path.join(path, "manifest.json")) as f:
            return float(json.load(f)["time"])
    except (OSError, ValueError, KeyError, json.JSONDecodeError):
        return None


def _snapshots_by_age(directory: str) -> List[str]:
    """Complete snapshot dirs, newest first (tmp dirs excluded; a
    `.replacing` aside counts — it IS a valid older snapshot)."""
    out = []
    for name in os.listdir(directory):
        full = os.path.join(directory, name)
        if name.startswith(".") or not os.path.isdir(full):
            continue
        t = _manifest_time(full)
        if t is not None:
            out.append((t, full))
    out.sort(key=lambda p: -p[0])
    return [full for _, full in out]


def _prune(directory: str, keep_last_n: int):
    for full in _snapshots_by_age(directory)[keep_last_n:]:
        shutil.rmtree(full)


def latest_checkpoint(directory: str) -> Optional[str]:
    """Newest usable snapshot. The LATEST pointer is authoritative while it
    points at a complete snapshot; when it is missing, dangling, or points
    at a torn directory (crash mid-publish), fall back to scanning for the
    newest directory with a parseable manifest."""
    if not os.path.isdir(directory):
        return None
    p = os.path.join(directory, "LATEST")
    if os.path.exists(p):
        with open(p) as f:
            tag = f.read().strip()
        full = os.path.join(directory, tag)
        if _manifest_time(full) is not None:
            return full
    snaps = _snapshots_by_age(directory)
    return snaps[0] if snaps else None


def load_checkpoint(path: str, mgr: MultiTaskManager) -> MultiTaskManager:
    """Restore manager state in place (tasks + both trainer feeds). Adapters
    and optimizer state come back as host numpy trees (the caller puts them
    on its device: ``MARLaaSRuntime.adopt_checkpoint``).

    `rollout_issued_version` is reset to version-1 so the next policy
    version is re-issued for rollout — in-flight work at crash time is
    regenerated, never resumed stale. A tenant checkpointed while
    `quarantined` restores as `admitted`: the breaker state machine does not
    survive restart, and a status with no breaker driving it would never
    unquarantine (the fresh breaker re-trips it if the faults persist)."""
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    with mgr._mgr_lock:
        mgr.q_buffer.clear()
        mgr.episodes.clear()
        mgr._partial.clear()
        mgr._inflight_train.clear()
        mgr._failed_groups.clear()
        for tid, entry in manifest["tasks"].items():
            spec = TaskSpec(**entry["spec"])
            adapters = opt_state = None
            if entry["has_adapters"]:
                adapters = flat_to_tree(
                    dict(np.load(os.path.join(path, f"{tid}_adapters.npz"))))
            if entry["has_opt"]:
                opt_state = flat_to_tree(
                    dict(np.load(os.path.join(path, f"{tid}_opt.npz"))))
            status = entry["status"]
            if status == "quarantined":
                status = "admitted"
            st = TaskState(spec=spec, adapters=adapters, opt_state=opt_state,
                           version=entry["version"],
                           steps_done=entry["steps_done"],
                           status=status,
                           abandoned=entry.get("abandoned", False),
                           rollout_issued_version=entry["version"] - 1,
                           submitted_at=mgr.clock())
            st.reward_history = list(entry.get("reward_history", []))
            for k, v in entry.get("counters", {}).items():
                setattr(st, k, v)
            mgr.tasks[spec.task_id] = st
        for b in manifest["buffer"]:
            arrs = dict(np.load(os.path.join(path, f"buffer_{b['idx']}.npz")))
            tb = TrajectoryBatch(
                task_id=b["task_id"], version=b["version"],
                tokens=arrs["tokens"], prompt_lens=arrs["prompt_lens"],
                total_lens=arrs["total_lens"], rewards=arrs["rewards"],
                group_size=b["group_size"],
                behavior_logprobs=(arrs["behavior"]
                                   if arrs["behavior"].size else None),
                meta=({"loss_mask": arrs["loss_mask"]}
                      if arrs["loss_mask"].size else {}))
            mgr.q_buffer.append(tb)
            # this version's rollout survived in the buffer — do NOT
            # re-issue it, or the duplicate would train stale after the
            # buffered copy commits
            st = mgr.tasks[tb.task_id]
            if tb.version == st.version:
                st.rollout_issued_version = st.version
        a = manifest.get("async")
        if a:
            for k, v in a.get("counters", {}).items():
                setattr(mgr, k, v)
            mgr._ep_seq = a.get("ep_seq", 0)
            if a.get("has_episodes"):
                with open(os.path.join(path, "episodes.pkl"), "rb") as f:
                    payload = load_episodes(f.read())
                for tid, groups in payload.items():
                    mgr.episodes[tid] = deque(groups)
        # reconcile the restored completed-row count against what actually
        # survived: rows completed before the crash whose round had not yet
        # assembled into a serialized batch/group are gone, and their round
        # re-issues (rollout_issued_version = version - 1) — the regenerated
        # rows count `completed` a second time. Attribute the lost copies
        # to `orphaned` so the conservation invariant stays EXACT across
        # the restart instead of leaking the regenerated double-count.
        completed = sum(st.rollout_rows_total for st in mgr.tasks.values())
        in_flight = (sum(tb.num_rows for tb in mgr.q_buffer)
                     + sum(len(g.rows) for dq in mgr.episodes.values()
                           for g in dq))
        accounted = (mgr.rows_trained + mgr.stale_rows_dropped
                     + mgr.discarded_tail_rows + mgr.failed_rows
                     + mgr.quarantine_dropped_rows + in_flight
                     + mgr.orphaned_rows)   # prior restarts' orphans
        mgr.orphaned_rows += max(0, completed - accounted)
        mgr._mgr_cv.notify_all()
    return mgr
