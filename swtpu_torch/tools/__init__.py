"""Measurement tools of the port that run on the card machine (the CUDA
toolkit and a GPU); no scoring path imports them."""
