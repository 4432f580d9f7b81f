"""Cell, scan, embedding and the CUDA decode-window kernel with its plain
version."""
