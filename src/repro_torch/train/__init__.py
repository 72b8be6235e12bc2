"""The train and serve step builders."""
