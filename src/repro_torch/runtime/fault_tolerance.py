"""Fault tolerance for the serving plane: the restart policy the router
restarts dead replicas under, and the seeded fault plan that injects
crashes and stalls into its workers.

Port of the serving half of the JAX package's ``runtime/fault_tolerance.py``
(pure host Python).  The training half — ``RestartPolicy.run``,
``TrainingFailure``, ``StragglerMonitor`` and ``simulate_failures`` — comes
with the training loop.
"""

from __future__ import annotations

import dataclasses
import random
import time
from typing import Callable, Dict, Tuple


@dataclasses.dataclass
class RestartPolicy:
    """Bounded restarts with exponential backoff.

    ``sleep`` is injectable so tests can run the policy with a no-op while
    production keeps the full computed delay: the backoff math and what is
    slept are the same code either way."""
    max_restarts: int = 10
    backoff_s: float = 1.0
    backoff_factor: float = 2.0
    max_backoff_s: float = 300.0
    sleep: Callable[[float], None] = time.sleep

    def backoff(self, restart_index: int) -> float:
        """Delay before restart #``restart_index`` (1-based), capped at
        ``max_backoff_s``."""
        return min(self.backoff_s * self.backoff_factor ** (restart_index - 1),
                   self.max_backoff_s)


class InjectedFault(RuntimeError):
    """Raised by a ``FaultPlan`` crash hook inside a replica worker: the
    deterministic stand-in for a device or driver failure killing the
    thread."""


@dataclasses.dataclass
class FaultPlan:
    """Seeded, deterministic fault-injection plan for the serving plane,
    consumed by ``launch/router.py`` (a replica's ``fault_hook`` is called
    with its worked-chunk counter):

      * ``crash_at``  — replica index → chunk index at which its worker
        raises ``InjectedFault`` (once; a restarted replica does not crash
        again);
      * ``stall_at``  — replica index → ``(chunk index, seconds)``: the
        worker sleeps before that chunk, a slow-chunk straggler that trips
        the router's watchdog (``SUSPECT``) and then recovers;
      * ``poison``    — request trace indices to serve with NaN logits;
      * ``corrupt_checkpoint`` — whether a checkpoint-integrity drill
        rewrites a committed shard with wrong bytes.

    Same seed ⇒ same plan ⇒ same injection points."""
    crash_at: Dict[int, int] = dataclasses.field(default_factory=dict)
    stall_at: Dict[int, Tuple[int, float]] = dataclasses.field(
        default_factory=dict)
    poison: Tuple[int, ...] = ()
    corrupt_checkpoint: bool = False
    sleep: Callable[[float], None] = time.sleep

    def __post_init__(self):
        self._fired: set = set()

    @classmethod
    def seeded(cls, seed: int, replicas: int, requests: int,
               crashes: int = 1, stalls: int = 1, poisons: int = 1,
               stall_s: float = 1.0, span: int = 6) -> "FaultPlan":
        """Draw a plan from ``seed``: ``crashes`` replicas die and
        ``stalls`` (different) replicas straggle at chunk indices in
        ``[1, span)``; ``poisons`` of the ``requests`` trace entries are
        NaN-poisoned."""
        rng = random.Random(seed)
        reps = list(range(replicas))
        rng.shuffle(reps)
        crashing = reps[:min(crashes, replicas)]
        stalling = reps[len(crashing):] or reps
        return cls(
            crash_at={r: rng.randrange(1, span) for r in crashing},
            stall_at={r: (rng.randrange(1, span), stall_s)
                      for r in stalling[:min(stalls, len(stalling))]},
            poison=tuple(sorted(rng.sample(range(requests),
                                           min(poisons, requests)))),
            corrupt_checkpoint=True,
        )

    def hook_for(self, replica: int) -> Callable[[int], None]:
        """The per-replica hook the router calls with its worked-chunk
        counter.  Each injection fires exactly once per plan instance."""
        def hook(chunk: int) -> None:
            stall = self.stall_at.get(replica)
            if (stall is not None and chunk >= stall[0]
                    and ("stall", replica) not in self._fired):
                self._fired.add(("stall", replica))
                self.sleep(stall[1])
            if (replica in self.crash_at
                    and chunk >= self.crash_at[replica]
                    and ("crash", replica) not in self._fired):
                self._fired.add(("crash", replica))
                raise InjectedFault(
                    f"fault plan: replica {replica} crash at chunk {chunk}")
        return hook

    def counts(self) -> Dict[str, int]:
        """Planned injection counts."""
        return {
            "crashes": len(self.crash_at),
            "stalls": len(self.stall_at),
            "poisoned_requests": len(self.poison),
            "corrupt_checkpoints": int(self.corrupt_checkpoint),
        }

    def fired(self) -> Dict[str, int]:
        """How many planned injections actually fired."""
        return {
            "crashes": sum(1 for k in self._fired if k[0] == "crash"),
            "stalls": sum(1 for k in self._fired if k[0] == "stall"),
        }
