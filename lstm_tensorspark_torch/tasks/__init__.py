"""Task runners behind the ``train`` command: the bi-LSTM classifier."""
