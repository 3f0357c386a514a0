"""The plain reference: answers worked out with plain PyTorch from the
per-record columns that set-up generated.  It imports nothing of the
program under test."""
