"""Static contract checker: proves the engine's identity, arena,
compile-set and shared-memory contracts from the port's own entry points
run on meta, before anything runs on a card. Port of `repro.analysis`;
`repro_torch.analysis.verify` is the CLI."""
from repro_torch.analysis.report import Finding, make_finding  # noqa: F401
