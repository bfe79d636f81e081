from gwen.cli.main import cli_entry

if __name__ == "__main__":
    raise SystemExit(cli_entry())
