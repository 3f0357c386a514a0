"""Core layout constants of the bitmap engine (own copy of
featurebase_tpu/core/consts.py, trimmed to what the port uses).

The reference (FeatureBase) fixes ShardWidth = 2^20 columns per shard
(reference: shardwidth/helper.go:15, fragment.go:37).  Each row of a fragment
is SHARD_WIDTH bits stored as 32768 32-bit words, little-endian bit order
within a word; on the device the words are int32 tensors with the same bits.
"""

# Number of columns per shard: 2^20 (reference shardwidth/helper.go:15).
SHARD_WIDTH = 1 << 20

WORD_BITS = 32

# 32-bit words per shard-row of bitmap.
WORDS_PER_ROW = SHARD_WIDTH // WORD_BITS  # 32768

# 2^16-bit roaring containers per shard-row (reference fragment.go:45
# shardVsContainerExponent), for the roaring import and export.
CONTAINERS_PER_ROW = SHARD_WIDTH >> 16  # 16

# BSI row layout within a bsig_ view (reference: fragment.go:62-65):
# row 0 = exists bit, row 1 = sign bit, rows 2..2+depth = magnitude bit slices.
BSI_EXISTS_ROW = 0
BSI_SIGN_ROW = 1
BSI_OFFSET = 2

# Number of key-translation / shard partitions (reference: disco/snapshot.go:24
# defaultPartitionN = 256).
PARTITION_N = 256
