"""The LSTM language model and generation."""
