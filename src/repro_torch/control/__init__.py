"""Closed-loop control plane: per-round controllers over measured feedback.
Port of ``repro/control`` (pure Python, copied).

feedback.py    — :class:`RoundFeedback` (one typed record per round, fed by
                 every measuring layer) + :class:`ControlKnobs` (everything
                 a controller may turn).
controllers.py — the :class:`Controller` protocol, the codec / sigma /
                 split / deadline controllers, :class:`ControllerSuite`,
                 and the config-keyed factory :func:`make_controllers`.

The trainer (core/gan.py) emits a ``RoundFeedback`` after every round and,
under ``cfg.control.mode='adaptive'``, consults the suite between rounds —
``knobs = suite(feedback_history, knobs)`` — applying the diff to the
engine (codec, deadline), the privacy stack (sigma), and the split planner
(strategy, per-boundary stages).  ``mode='frozen'`` (default) applies
nothing and stays bit-exact with the static build.
"""
from repro_torch.control.controllers import (CodecController, Controller,
                                             ControllerSuite,
                                             DeadlineController,
                                             SigmaController, SplitController,
                                             make_controllers)
from repro_torch.control.feedback import (ControlKnobs, RoundFeedback,
                                          knobs_from_config)

__all__ = [
    "CodecController", "Controller", "ControllerSuite", "ControlKnobs",
    "DeadlineController", "RoundFeedback", "SigmaController",
    "SplitController", "knobs_from_config", "make_controllers",
]
