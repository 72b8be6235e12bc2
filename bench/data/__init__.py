"""Data kinds of the traffic mixes, one module each, found by the name a
mix's ``"data": {"kind": ...}`` gives (``generator.make``)."""
