"""The streaming outer sync (counterpart of ``hypha_tpu/stream``).

  * :mod:`partition` -- the deterministic, size-balanced split of the
    parameter tree into F fragments (a pure function of ``{name: size}``);
  * :mod:`sync`      -- the staggered schedule (fragment ``r mod F`` due at
    round ``r``) and the delayed-update correction ``merge_corrected``;
  * :mod:`accum`     -- the parameter server's streaming sample-weighted
    fold, ``RoundAccum``.

Selection is per job through ``sync_mode: blocking | overlap | stream``.
The sharded placement, the tree reduce and the broadcast tree are not
ported (ROADMAP.md, Queue 1: sharded PS/FT/rejoin).
"""

from .accum import RoundAccum
from .partition import fragment_of, partition_names
from .sync import (
    DEFAULT_FRAGMENTS,
    SYNC_MODES,
    effective_fragments,
    fragment_due,
    merge_corrected,
    placement_parts,
)

__all__ = ["RoundAccum", "partition_names", "fragment_of", "SYNC_MODES", "DEFAULT_FRAGMENTS",
           "fragment_due", "effective_fragments", "placement_parts", "merge_corrected"]
