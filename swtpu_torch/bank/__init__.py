from swtpu_torch.bank.scorebank import ScoreBank, ScoreResult

__all__ = ["ScoreBank", "ScoreResult"]
