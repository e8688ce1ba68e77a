"""Small utilities: seeding and saving."""
