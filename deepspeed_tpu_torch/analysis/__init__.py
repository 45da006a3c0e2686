"""``deepspeed_tpu_torch.analysis`` — the port's guards (counterpart of
``deepspeed_tpu/analysis``).

Static side: ``python -m deepspeed_tpu_torch.analysis deepspeed_tpu_torch/``
runs six AST rule families over the port (``lint.py``, ``rules.py``):
host syncs and fresh allocations in the serving and training hot functions
(DSTPU001/002), untyped raises and string-matched dispatch (DSTPU003),
nondeterministic decisions and key material (DSTPU005), open transfer
tickets read without a drain (DSTPU006) and mutate-before-raise in hot
paths (DSTPU007), against the checked-in ``baseline.txt``. DSTPU004, the
JAX package's retrace rule, has no counterpart here.

Program audit: every step program goes through :func:`audited_program`,
which fingerprints its dispatcher operations on its first eager call of
each input signature and checks them, and its trace count, against the
pinned ``programs.json`` (``DSTPU_AUDIT=1``, or :func:`armed`;
``DSTPU_AUDIT=write`` re-pins). Off by default.

Runtime side: ``DSTPU_SANITIZE=1`` arms checked mode — the engine builds
the self-verifying KV block cache (:func:`checked_cache_cls`), every
``Request.state`` assignment is validated, and the scheduler runs its
between-steps and drain checks. Off by default.
"""

from .baseline import apply as apply_baseline  # noqa: F401
from .baseline import default_path as default_baseline_path  # noqa: F401
from .baseline import load as load_baseline  # noqa: F401
from .baseline import save as save_baseline  # noqa: F401
from .lint import Finding, lint_file, lint_paths, lint_source  # noqa: F401
from .program_audit import (ProgramAuditError,  # noqa: F401
                            ProgramRegistry, armed, assert_trace_bounds,
                            audited_program, check_manifest,
                            default_manifest_path)
from .rules import ALL_RULE_IDS, HOT_FUNCTIONS, RULES, Rule  # noqa: F401
from .sanitizer import (IllegalTransitionError,  # noqa: F401
                        LEGAL_TRANSITIONS, SanitizerError, check_drained,
                        check_transition, checked_cache_cls,
                        sanitize_enabled)
