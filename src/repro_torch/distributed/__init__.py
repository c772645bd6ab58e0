"""Multi-device placement, counterpart of ``repro.distributed``: the
slot-axis helpers the mesh serving backend uses (`distributed.sharding`).
"""
from repro_torch.distributed.sharding import (shard_count, slot_mesh,
                                              visible_cards)

__all__ = ["shard_count", "slot_mesh", "visible_cards"]
