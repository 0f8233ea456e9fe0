"""Fixture rules: covers "batch" only."""

FIXTURE_RULES = {
    "batch": "dp",
}
