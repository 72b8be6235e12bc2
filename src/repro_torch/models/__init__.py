"""The LM stack (the port of ``repro.models``): the token-input families,
dense, moe, ssm and hybrid."""
