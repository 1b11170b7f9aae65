"""``python -m hypha_tpu_torch`` — the node CLI (see hypha_tpu_torch.cli)."""

from .cli import main

raise SystemExit(main())
