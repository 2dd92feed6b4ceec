"""Model families over the approximate compute layers (dense `lm` only)."""
