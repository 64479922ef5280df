from swtpu_torch.bank.scorebank import LoadedDatabase, ScoreBank, ScoreResult

__all__ = ["LoadedDatabase", "ScoreBank", "ScoreResult"]
