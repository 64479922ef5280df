from swtpu_torch.bank.buckets import BucketPlan, plan_buckets
from swtpu_torch.bank.packer import PackedBatch, pack_many_vs_one, pack_pairs
from swtpu_torch.bank.scorebank import LoadedDatabase, ScoreBank, ScoreResult
from swtpu_torch.bank.serving import ShardedLoadedDatabase

__all__ = [
    "BucketPlan",
    "plan_buckets",
    "PackedBatch",
    "pack_pairs",
    "pack_many_vs_one",
    "LoadedDatabase",
    "ShardedLoadedDatabase",
    "ScoreBank",
    "ScoreResult",
]
