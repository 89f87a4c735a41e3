"""Box and anchor math."""
