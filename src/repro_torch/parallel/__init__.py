"""Logical-axis sharding over a mesh of ``torch.distributed`` ranks: the
counterpart of ``repro.parallel`` (its serving half; ``pipeline.py`` is
ROADMAP A10's train half).  Importing it initialises no process group."""
from repro_torch.parallel.axes import (  # noqa: F401
    DEFAULT_RULES,
    PartitionSpec,
    constrain,
    local_slice,
    resolve_spec,
    sharding_ctx,
    tree_shardings,
)
from repro_torch.parallel.sharding import layout_report, rules_for  # noqa: F401
