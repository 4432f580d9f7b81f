"""Cell, scan and its kernel dispatch, embedding, and the hand-written CUDA
kernels (decode window, LSTM recurrence forward and backward) with their
plain versions."""
