"""Architecture configs the port supports."""
