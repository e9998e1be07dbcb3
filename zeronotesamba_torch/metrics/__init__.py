"""Beat-tracking metrics (numpy)."""
