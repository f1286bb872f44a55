"""Join-engine configurations: ``paper_clftj`` holds
:class:`~.paper_clftj.JoinEngineConfig` and its presets."""
