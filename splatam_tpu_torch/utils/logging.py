"""Experiment metric logging: wandb when available, JSONL fallback otherwise.

The reference logs per-iteration losses, per-frame tracking/mapping metrics,
Gaussian counts, qualitative figures, and final runtime stats to wandb
(utils/eval_helpers.py:80-106,166-208; scripts/splatam.py:954-959). This
module keeps that contract behind one object: when `use_wandb` is set and
the wandb package exists, a real run is created; when the package is absent
(this environment has no wandb and no egress) the same stream is written to
`<workdir>/<run_name>/wandb_fallback.jsonl` so the data is still captured
and the call sites stay identical.

A copy of splatam_tpu/utils/logging.py (no jax); wandb is imported only
inside MetricsLogger, when logging is on.
"""
from __future__ import annotations

import json
import os
import time


class MetricsLogger:
    """wandb-compatible logger: .log(dict, step)/.log_figure/.finish.

    No-op when `enabled` is False. With wandb installed, delegates to a real
    wandb run; otherwise appends JSON lines to a fallback file.
    """

    def __init__(self, enabled: bool, config: dict | None = None,
                 output_dir: str | None = None):
        self.enabled = enabled
        self._run = None
        self._file = None
        self.step = 0  # mirrors the reference's wandb_time_step counters
        if not enabled:
            return
        try:
            import wandb  # noqa: F401 — optional dependency

            wcfg = (config or {}).get("wandb", {})
            self._run = wandb.init(
                project=wcfg.get("project", "SplaTAM-TPU"),
                entity=wcfg.get("entity"),
                group=wcfg.get("group"),
                name=wcfg.get("name"),
                config=config,
            )
        except Exception as exc:  # ImportError, or wandb.init failing
            # (no network/auth in a zero-egress environment) — either way
            # fall through to the JSONL logger instead of aborting the run.
            if not isinstance(exc, ImportError):
                print(f"[splatam-torch] wandb.init failed ({exc!r}); "
                      "falling back to JSONL logging")
            if output_dir is not None:
                os.makedirs(output_dir, exist_ok=True)
                path = os.path.join(output_dir, "wandb_fallback.jsonl")
                self._file = open(path, "a", buffering=1)
                print(f"[splatam-torch] logging metrics to {path}")
            else:
                self.enabled = False

    def log(self, metrics: dict, step: int | None = None):
        if not self.enabled:
            return
        if self._run is not None:
            self._run.log(metrics, step=step)
        elif self._file is not None:
            rec = {"_step": self.step if step is None else step,
                   "_ts": round(time.time(), 3)}
            for k, v in metrics.items():
                try:
                    json.dumps(v)
                    rec[k] = v
                except TypeError:
                    rec[k] = float(v) if hasattr(v, "__float__") else repr(v)
            self._file.write(json.dumps(rec) + "\n")
        if step is None:
            self.step += 1
        else:
            self.step = max(self.step, step + 1)

    def log_figure(self, key: str, fig, step: int | None = None):
        """Log a matplotlib figure (wandb.Image upstream; saved PNG here)."""
        if not self.enabled:
            return
        if self._run is not None:
            import wandb

            self._run.log({key: wandb.Image(fig)}, step=step)
        elif self._file is not None:
            fig_dir = os.path.join(os.path.dirname(self._file.name), "wandb_figures")
            os.makedirs(fig_dir, exist_ok=True)
            name = f"{key.replace('/', '_')}_{self.step if step is None else step}.png"
            fig.savefig(os.path.join(fig_dir, name), bbox_inches="tight")
            self.log({key: os.path.join("wandb_figures", name)}, step=step)

    def finish(self):
        if self._run is not None:
            self._run.finish()
        if self._file is not None:
            self._file.close()
            self._file = None


def report_loss(logger: MetricsLogger, losses: dict, step: int,
                tracking: bool = False, mapping: bool = False) -> int:
    """Per-iteration loss stream. Parity: report_loss
    (utils/eval_helpers.py:80-106) — same key names per phase."""
    if tracking:
        prefix = "Per Iteration Tracking"
    elif mapping:
        prefix = "Per Iteration Mapping"
    else:
        prefix = "Per Iteration Current Frame Optimization"
    logger.log(
        {
            f"{prefix}/Loss": float(losses["loss"]),
            f"{prefix}/RGB Loss": float(losses["im"]),
            f"{prefix}/Depth Loss": float(losses["depth"]),
            f"{prefix}/step": step,
        },
        step=step,
    )
    return step + 1
