"""Experiment tracking: MLflow when a tracking URI is given, JSONL otherwise
(copy of artspeech_tpu/utils/tracking.py, except that an MLflow tracker that
cannot start raises instead of giving way to the local one).

The reference logs params/metrics/artifacts to MLflow in every trainer
(train_phoneme_to_articulation.py:402-414, 269-314). Here the tracker is an
injectable object so training loops stay tracker-agnostic; the local backend
writes params.json + metrics.jsonl + copied artifacts under the run dir,
which is what the report tooling consumes.
"""

import json
import os
import shutil
import time
from typing import Dict, Optional


class LocalTracker:
    """Filesystem tracker: params.json, metrics.jsonl, artifacts/."""

    def __init__(self, run_dir: str):
        self.run_dir = os.path.abspath(run_dir)
        os.makedirs(self.run_dir, exist_ok=True)
        self._metrics_path = os.path.join(self.run_dir, "metrics.jsonl")
        self._params_path = os.path.join(self.run_dir, "params.json")

    def log_params(self, params: Dict):
        existing = {}
        if os.path.isfile(self._params_path):
            with open(self._params_path) as f:
                existing = json.load(f)
        existing.update({k: _jsonable(v) for k, v in params.items()})
        with open(self._params_path, "w") as f:
            json.dump(existing, f, indent=2)

    def log_metrics(self, metrics: Dict, step: Optional[int] = None):
        rec = {"ts": time.time(), "step": step}
        rec.update({k: _jsonable(v) for k, v in metrics.items()})
        with open(self._metrics_path, "a") as f:
            f.write(json.dumps(rec) + "\n")

    def log_artifact(self, path: str, name: Optional[str] = None):
        dst_dir = os.path.join(self.run_dir, "artifacts")
        os.makedirs(dst_dir, exist_ok=True)
        dst = os.path.join(dst_dir, name or os.path.basename(path))
        if os.path.isdir(path):
            src = os.path.abspath(path)
            # Never copy the artifacts dir into itself (or an ancestor of it
            # into it — that would recurse into our own output).
            if (
                src == dst_dir
                or src.startswith(dst_dir + os.sep)
                or dst_dir.startswith(src + os.sep)
            ):
                return
            shutil.copytree(path, dst, dirs_exist_ok=True)
        else:
            shutil.copy2(path, dst)

    def log_dict(self, d: Dict, name: str):
        dst_dir = os.path.join(self.run_dir, "artifacts")
        os.makedirs(dst_dir, exist_ok=True)
        with open(os.path.join(dst_dir, name), "w") as f:
            json.dump(_jsonable(d), f, indent=2)

    def end(self):
        pass


class MlflowTracker:
    """Thin MLflow adapter with the same interface."""

    def __init__(
        self,
        tracking_uri: str,
        experiment: str,
        run_id: Optional[str] = None,
        run_name: Optional[str] = None,
    ):
        import mlflow

        self._mlflow = mlflow
        mlflow.set_tracking_uri(tracking_uri)
        mlflow.set_experiment(experiment)
        self._run = mlflow.start_run(run_id=run_id, run_name=run_name)
        self.run_dir = None

    def log_params(self, params: Dict):
        self._mlflow.log_params({k: str(v) for k, v in params.items()})

    def log_metrics(self, metrics: Dict, step: Optional[int] = None):
        self._mlflow.log_metrics(
            {k: float(v) for k, v in metrics.items() if _is_number(v)}, step=step
        )

    def log_artifact(self, path: str, name: Optional[str] = None):
        if os.path.isdir(path):
            self._mlflow.log_artifacts(path, artifact_path=name)
        else:
            self._mlflow.log_artifact(path)

    def log_dict(self, d: Dict, name: str):
        self._mlflow.log_dict(_jsonable(d), name)

    def end(self):
        self._mlflow.end_run()


class NullTracker:
    """The tracker of a rank that does not write (every rank but rank 0 of a
    data-parallel run): the same interface, and nothing is recorded."""

    run_dir = None

    def log_params(self, params: Dict):
        pass

    def log_metrics(self, metrics: Dict, step: Optional[int] = None):
        pass

    def log_artifact(self, path: str, name: Optional[str] = None):
        pass

    def log_dict(self, d: Dict, name: str):
        pass

    def end(self):
        pass


def make_tracker(
    run_dir: str,
    mlflow_uri: Optional[str] = None,
    experiment: Optional[str] = None,
    run_id: Optional[str] = None,
    run_name: Optional[str] = None,
):
    """An ``MlflowTracker`` when ``mlflow_uri`` is given (its errors, such as
    a missing ``mlflow`` package, propagate), else a ``LocalTracker``."""
    if mlflow_uri:
        return MlflowTracker(mlflow_uri, experiment or "default", run_id, run_name)
    return LocalTracker(run_dir)


def _is_number(v) -> bool:
    try:
        float(v)
        return True
    except (TypeError, ValueError):
        return False


def _jsonable(v):
    if isinstance(v, dict):
        return {k: _jsonable(x) for k, x in v.items()}
    if isinstance(v, (list, tuple)):
        return [_jsonable(x) for x in v]
    if hasattr(v, "item") and getattr(v, "size", 2) == 1:
        return v.item()
    if isinstance(v, (str, int, float, bool)) or v is None:
        return v
    return str(v)
