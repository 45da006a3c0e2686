"""ZeRO on one card (counterpart of ``deepspeed_tpu/runtime/zero``): the config
block, the partition plan, the offloaded and sharded optimizer tiers, and
``TiledLinear``."""
