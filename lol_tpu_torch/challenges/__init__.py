"""L7 — the RLWE / RLWR challenges executable.

Counterpart of `lol_tpu/challenges` (the reference's `rlwe-challenges`,
SURVEY.md §3.8): three phases over a directory of protobuf files.

- **generate**: per challenge, sample N RLWE / RLWR instances, each with
  its own secret, and write `.challenge` / `.instance` / `.secret` files.
- **suppress**: once the beacon value for the challenge's epoch is
  available, delete the secret of the one instance the beacon bits select
  (cut-and-choose: every other secret is revealed, so at most one
  instance per challenge stays hard).
- **verify**: for every revealed secret, recompute the error term and
  check its ||g e||^2 bound; check the beacon's selection.

The default beacon, `LocalBeacon`, derives the bits by SHA-512 of the
epoch (deterministic and offline); `NistRecordBeacon` reads pre-fetched
NIST beacon records.  The CLI is `python -m lol_tpu_torch.challenges.driver`
(`rlwe-challenges-torch` once installed).
"""

from .beacon import LocalBeacon  # noqa: F401
from .driver import ChallengeParams, generate, main, suppress, verify  # noqa: F401
