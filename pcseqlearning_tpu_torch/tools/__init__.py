"""The port's tool entry points: the offline Waymo conversion and its
follow-ups, the database builders, and measurement scripts run on the
card."""
