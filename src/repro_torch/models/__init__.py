"""Model families over the approximate compute layers: the dense `lm`
transformer, the `ssm` Mamba-2 and the `hybrid` RecurrentGemma, and the
CNNs of the paper's evaluation."""
